#!/usr/bin/env python3
"""Drive the PyTorch port (saragan_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA versions;
   no CUDA device -> exit 1 before anything else;
2. build: nvcc compiles every CUDA source of the port (one process per source, all
   started together) and the build time is printed, with the registers and spills ptxas
   reports for each conv kernel and each fused bias+lrelu+pixel-norm kernel, and the count
   of tensor-core (HMMA) instructions in each bf16 conv library's SASS (cuobjdump), which
   must not be 0;
3. kernels against their plain PyTorch versions, on the card, at every shape the
   phase-6 batch-8 serving forward gives them (TF32 off):
   - fused bias+lrelu+pixel-norm (CUDA C++, csrc/fused_bias_act.cu): rtol 1e-5, atol
     1e-6, pixel norm on and off; a sample computed alone bit-equal to its slot in the
     batch of 8; timed three ways (``tools/profile_fused.time_three_ways``: per-call
     events, device time of calls queued behind a sleep, host enqueue time);
   - conv3d forward (CUDA C++, CUDA cores): max|kernel - plain| <= 1e-4 * max|plain|,
     bit-identical on a rerun, with its plan, TFLOP/s and share of the bound;
   with each kernel's time, its plain version's time, F.conv3d's time (the library
   yardstick; the port's flat engine never calls it) and the least time the card could
   take for the same work;
4. serving: a phase-6 pgan 'xs' generator with random weights from the port's own init,
   served over HTTP under the `direct` and then the `flat` conv engine; four concurrent
   requests (1, 3, 8, 8 volumes of 32x128x128) must come back finite and of the right
   shape, be coalesced, equal the same requests served alone bit for bit, launch 11
   fused kernels and 6 (flat) or 0 (direct) conv kernels per dispatch and no plain
   version; the two engines must agree;
5. training: the reference bench's flagship step (``bench.py:99-119``: pgan 'xs',
   WGAN-GP, Adam, bf16 activations with f32 state, fused transitions, shared-fake-pass
   gradients, the stacked critic pass) at phase 6, batch 8, with the fused op on, from the
   port's seeded init on the card and random 'real' volumes from numpy.  Under `flat`
   and then `direct`: per half (mixing at alpha 0.5, stabilizing at static alpha 0) one
   warm-up step and 5 timed steps (CUDA events, median) with the peak device memory;
   every loss finite, parameters and EMA moved; under `flat` each step launches the
   forward, dgrad, wgrad and fused kernels as often as its warm-up step did, every conv
   through the tensor-core route ("tc", bf16) and none through the CUDA-core one ("simt"),
   and no plain version runs; under `direct` no conv kernel runs; under both the fused
   op's backward kernel runs once per forward launch (11 per step); under `flat` one
   more step per half is profiled for its kernel count and the host's launch calls;
6. training kernels against their plain versions, on the card, at every shape that
   step launched them with, in f32 (CUDA cores) and bf16 (tensor cores): max|kernel -
   plain| <= 1e-4 (f32) or 1e-2 (bf16) * max|plain|; forward, dgrad and wgrad
   bit-identical across two runs; each with its time, its plain version's, the library
   call's (``F.conv3d`` for forward and dgrad, ``aten.convolution_backward`` with only the
   weight mask for wgrad) and its bound, with its TFLOP/s and share of the bound; the
   fused op's backward kernel in f32 and bf16 against its plain version and against
   autograd of the reference's oracle (the backward it replaces): f32 gx within 1e-6 +
   1e-5 * max(|gx|, |r g| + |a r^3 s / C|) (gx is the difference of those two terms, so
   its rounding error scales with them), gb within rtol 1e-5 plus 1e-5 * ||gx_c||_2 (a
   sum of N * S terms: a
   reordered f32 sum differs by a multiple of that, not of |gb_c|); bf16 within 1e-2 *
   max|reference|; gx and gb bit-identical on a rerun; y (bf16) and gx (f32 and bf16) of
   a sample computed alone bit-equal to its slot in the batch of 8; one launch per
   backward call (torch.profiler); the forward's and the backward's three times
   (``time_three_ways``), the plain version's, the oracle's autograd's, the
   autograd.Function's backward and the bound;
7. one f32 step's gradients under `flat` and `direct` from the same state and the same
   pre-drawn z and gamma: losses within 1e-3 relative, every gradient within
   1e-3 * max|g|; under `flat` every conv (forward, dgrad, wgrad) through the CUDA-core
   kernels; then the f32 gradient computation under `flat` timed (median of 5 after a
   warm-up, CUDA events) on a line of its own;
8. the trainer through its CLI (``cli.main`` in process): the flagship configuration from
   phase 5 (batch 16) into phase 6 (batch 8), 32 + 32 images per phase, no --conv_engine (so
   `flat`, the card's default: events.jsonl must say so), bf16, the fused op on, on a seeded
   npy dataset written to a temp dir (16 volumes of 16x64x64 and 16 of 32x128x128), with the
   metric passes (--calc_metrics, FID over 512-d random features, ``SMOKE_FID_DIM``, SWD,
   SSIM, PSNR; once per phase and at each phase's end).  It must exit normally and write
   model_5.npz and model_6.npz; phase 6 must hold every phase-5 name of model_5.npz bit for
   bit through its frozen mixing half (its cadence checkpoint after that half); events.jsonl
   must hold finite Loss/d_loss, Loss/g_loss and Loss/gp in both phases, a histogram event,
   and finite fid, fid_EMA, PSNR, ssim, swd_mean and their end-of-phase _validation / _test
   tags in both phases; kernels #1 (forward and dgrad), #2 and #4 (and its backward) must
   have run, the convs through the tensor-core route only, and no plain version.  The input
   pipeline is the native C++ prefetcher, the default: the log and events.jsonl must say so.
   Prints ms/step per phase and half (CUDA events, median after the first), img/s, the
   phase's peak memory, the ms per step without the metric passes and with their host time
   spread over the steps, and the host's wait for each step's batch
   (``Timing/input_wait_ms``).  Then phase 5 alone again with --no_native_prefetch (the
   Python prefetch thread, no metric passes): its model_5.npz must equal the native run's
   bit for bit; its input wait is printed beside the native run's;
9. bitwise resume: the same command in a subprocess with --full_state_checkpoints gets
   a SIGTERM once phase 6 printed its second step line and must exit 75; rerun with
   --auto_resume it must exit 0 with a model_6.npz equal to the uninterrupted run's,
   every array bit for bit;
9b. metrics (the slice's own path, counts set to 0 before it): ``generate()``'s report
   at phase 6 for 8 volumes of 32x128x128 from the serving generator, every metric on,
   FID over random features (the --allow_uncalibrated_fid route), then FID over the
   Inception network with random parameters from an npz: values finite, FID(real, real)
   at most 1e-2 of FID(real, fake), the fused kernel and no plain version run; Inception
   features of 8 slices on the card within 1e-3 * max|CPU| of the CPU's; seconds of
   extraction (card) against the numpy/scipy arithmetic (host);
10. kernel #3 (conv3d_flat_v2, CUDA C++) at every serving-forward shape in f32 (CUDA
   cores): max|kernel - plain| <= 1e-4 * max|plain|, within the same limit of kernel #1,
   bit-identical on a rerun, through the route of its dtype; with its plan, its time,
   kernel #1's, F.conv3d's, the bound, its TFLOP/s and share of the bound;
10b. engines (``--only engines``): the flagship step (phase 6, batch 8, bf16, the mixing
   half) under each conv formulation of the JAX package's SARAGAN_CONV3D besides direct
   and flat (``ENGINES``: flat_v2, the reference's pallas2; gemm; gemm_custom with the
   library's wgrad and with einsum; hybrid; s2d), from one seeded state: a warm-up and 3
   steps with the counts set to 0 just before (ms, median; peak MiB), finite losses, no
   plain version, #1 and #2 never launched, under flat_v2 kernel #3 launched as often a
   step as #1 under flat (28 forward, 39 dgrad) through the tensor-core route; each
   engine's f32 gradient computation from the same state and pre-drawn z and gamma within
   1e-3 * max|g| of direct's, losses within 1e-3 relative, and whether a rerun is
   bit-equal (printed, not a gate); #3 against its plain version at every shape of the
   flat_v2 bf16 step (forward and dgrad) and of its f32 gradient computation (the limits
   of phase 10, bf16 1e-2); the phase-8 batch-2 single_chip_big_volume step under the
   preset's formulation and with the window pool and compute-dtype statistics (ms, peak
   MiB); one phase-6 batch-8 f32 serving forward under direct, s2d and gemm (within 1e-4 *
   max|direct|, ms);
11. kernel #5 (minibatch_stddev_stat, CUDA C++, csrc/minibatch_stddev.cu, standalone)
   with group 4 at N 8 and 16, at the per-sample feature counts of the largest and
   smallest phase-6 D activation, f32 and bf16 input, and group 3 (not a template size)
   at N 12: within 1e-5 of max|plain|, bit-identical on a rerun, one launch per call
   (counted, and one launch call in a torch.profiler trace); timed three ways
   (``time_three_ways``) with its bound (bytes / 3.35 TB/s);
12. big volume: the flagship at phase 8 (128x512x512, C = 8 at full resolution) under
   the ``single_chip_big_volume`` preset (host-offloaded block taps, the unstacked
   critic, unfused transitions, bf16, the fused op on), at the flagship schedule's batch
   there (2):
   (a) the first step from the seeded init with pre-drawn z and gamma, bit-equal (every
   parameter, Adam slot, EMA entry and loss) to the same configuration without
   remat_offload and to one with plain remat; then the main path, the preset's step
   chained, a warm-up and 5 timed steps with the counts set to 0 just before: ms per step
   (median, CUDA events), volumes/s, peak MiB, MiB parked in host memory per step, finite
   losses, the kernels launched through the tensor-core route, no plain version;
   (b) kernels #1, #1' and #2 at that step's 128x512x512 shapes and #4 forward and
   backward at its two 128x512x512 calls, bf16, against their plain versions with the
   limits of phases 3 and 6 (1e-2 of max|plain| in bf16; #4's backward also in f32),
   bit-identical reruns, with their times, F.conv3d's / convolution_backward's and bounds;
   (c) the trainer through its CLI with --single_chip_big_volume --use_pallas_fusion at
   phase 8 (4 + 4 images at batch 2) on a seeded set of 4 volumes of 128x512x512
   written to a temp dir: it must return, write model_8.npz with finite parameters, a
   finite Loss/d_loss event and the flat engine, and run the kernels, no plain version;
   the EMA sampler draws one finite volume of 128x512x512 from model_8.npz (f32, flat);
13. families: surfgan at the flagship's settings (``bench.py:99-119`` with
   architecture="surfgan": WGAN-GP, bf16, fused transitions, shared fake pass, the stacked
   critic pass whose minibatch-stddev groups form inside each half) under `flat`:
   (a) its phase-6 batch-8 step from the seeded init, per half a warm-up and 5 timed steps
   with the counts set to 0 just before: ms/step, vol/s, peak MiB, finite losses, #1, #1'
   and #2 launched through the tensor-core route only, no plain version, parameters, EMA
   and ``generator/d_z_avg`` (refresh_state) moved, a conv with C = F + 1 (the stddev
   channel) among the step's shapes; (b) #1, #1' and #2 at every conv shape of that step
   in f32 and bf16 against their plain versions, as in phase 6; (c) the CLI from phase 5
   (batch 16) into phase 6 (batch 8), 16 + 16 images per phase on the seeded dataset:
   model_5.npz and model_6.npz finite, model_6.npz with the phase-6 init's names and
   shapes, finite d_loss, the flat engine, the kernels run and no plain version,
   ``d_z_avg`` moved in each phase; (d) 4 concurrent requests served
   from model_6.npz (f32, `direct`): finite volumes, coalesced, each alone bit-equal to its
   coalesced response (per-row noise seeds); (e) one bf16 `flat` step of each of pgan2,
   pgandeep, stylegan and stylegan2 at phase 4, batch 8: finite losses, parameters moved,
   #1, #1' and #2 launches by route printed;
14. hpo: the flagship configuration (pgan 'xs', WGAN-GP, bf16, fused transitions, shared
   fake pass, stacked critic, the fused op, `flat`) at phase 6, batch 8:
   (a) each of the eight optimizers (Adam, SGD, Momentum, Adadelta, RAdam, LAMB, LARS,
   AdamW) for two mixing steps of the flagship step with the previous phase's names
   frozen, the counts set to 0 just before: finite losses, the other parameters moved,
   the frozen ones did not, #1, #1', #2 and #4 (and its backward) launched exactly as
   under Adam through the tensor-core route, no plain version; one update of G and D on
   the card against the same update on the CPU from the same state and gradients
   (max|card - CPU| within 1e-6 of max|CPU| per tensor) and its time (CUDA events, median
   of 5) beside Adam's;
   (b) a 2-trial TPE study through the CLI (``cli.main`` in process, counts set to 0 just
   before and read just after) on the seeded dataset: phase 6 only, 8 + 8 images a trial,
   the learning rates, their schedules, both optimizers, the betas, rho and momentum
   drawn by each trial (passed as None), scored by FID over 512-d random features (a metric
   pass at the first step and the validation split's at the phase's end): every trial
   COMPLETE with a finite value, its params covering the drawn names, the kernels
   launched and no plain version, the device memory allocated at every trial's start and
   after the study equal to the byte; seconds and peak MiB per trial;
   (c) best-trial replay of that database (``--optuna_use_best_trial``, a subprocess, no
   metric pass): exit 0, the best trial's number and params replayed; (d) two inter-trial workers
   (``--optuna_distributed``, SARAGAN_WORKER_ID 0 and 1, SARAGAN_NUM_WORKERS 2, no metric
   pass) on a new SQLite study, subprocesses sharing the card with (c): both exit 0, two
   COMPLETE trials, one per worker, each worker's checkpoint in its own logdir;
   (e) the generate CLI with ``--config_args --first_conv_nfilters 64`` on a surfgan
   checkpoint written with a 64-filter first layer: two finite 32x128x128 volumes;
15. tools: the rest of tools/ at the flagship's width (bench.py:99-119's model at phase 6,
   batch 8):
   (a) ``tools.test_network``'s CLI for each of the six families (f32, the engine resolved
   for the card), counts set to 0 before each: finite losses, the 32x128x128 output, #1,
   #1' and #2 launched through the CUDA-core route, no plain version; the kernels against
   their plain versions (f32) at every conv shape of those steps not checked before;
   (b) ``tools.export_model``'s CLI on the trainer's phase-6 pgan checkpoint (seeded init
   params under ``--only tools``), the artifact served over HTTP (``from_artifact``), 4
   concurrent requests: finite volumes, coalesced, each alone bit-equal to its coalesced
   response, no hand-written kernel launched (the artifact holds none, by the reference's
   design); the artifact bit-equal to the live generator under `direct` (fused
   transitions, no fused op) on the same z and within 1e-4 * max|ref| of the checkpoint
   path under `flat` with the fused op; its MB and the ms per batch-8 forward of the
   artifact and of the checkpoint path under `direct` and `flat` (CUDA events, median of
   20); the artifact loaded in a subprocess that never imports the package, bit-equal;
   (c) the same checkpoint (params + EMA) through ``tools.tf_checkpoint``'s export, show
   and import: every array bit-equal, the service over the imported npz bit-equal to the
   service over the original; seconds per pass, the CRC-32C route and its MB/s;
   (d) a synthetic LIDC-like CT series (160 slices of 512x512 int16, slope 1, intercept
   -1024, 2.5 x 0.703125 x 0.703125 mm, written with ``tools.dicom.write_ct_slice``)
   through ``tools.prepare_data.create_dataset`` on the card: 8 levels, 128x512x512 down to
   1x4x4, each within 2^-21 (HU/1024 units) of the same stages on the CPU; the device
   stages' seconds per volume, card and CPU; the 128x128 level read by
   ``get_numpy_dataset`` at phase 6;
16. the 2-D path (``--only two_d``): pgan at ProGAN's published widths (the repo's 2-D
   'm' table over nine phases, 4^2 -> 1024^2: 512 filters to 32^2, then 256, 128, 64, 32,
   16; latent 512, 3x3 kernels: Karras et al. 2018, Table 2), G on Adam and D on LAMB
   (weight decay 0.004) under WGAN-GP, bf16, the fused op on, no --conv_engine:
   (a) the JPEG decoder this machine has, printed: libjpeg (the host library built with
   jpeglib.h) held within 1.5/127.5 of PIL and bit-equal to the plain PyTorch triangle
   resize, or PIL held within 1.5/127.5 of that plain resize, on a seeded class folder
   (64 train and 16 test images of 256^2, written with PIL);
   (b) the native prefetcher: 3 batches of 8 flagship phase-6 volumes, f32 and bf16,
   bit-equal to the Python path's on the same paths, pinned;
   (c) the CLI (in process, counts set to 0 just before and read just after) from phase
   6 (128^2, batch 16) into phase 7 (256^2, batch 8), 32 + 32 images per phase, on that
   folder: model_6.npz and model_7.npz with 2-D weights (3x3 convs, 1x1 RGB heads),
   finite; phase 7 holding model_6's names bit for bit through its frozen mixing half;
   finite Loss/d_loss, Loss/g_loss and Loss/gp in both phases; #4's forward and backward
   launched, no conv kernel (rank 2 is `direct`) and no plain version; the decoder and
   the input pipeline (the Python thread: JPEG folders are not path-based npy files)
   in the log.  Prints ms/step per phase and half (CUDA events, median after the first),
   img/s, peak MiB and the input wait;
   (d) the phase-7 EMA generator served at batch 8 in f32 over HTTP, 4 concurrent
   requests (1, 3, 8, 8 RGB images of 256^2): finite, coalesced, each alone bit-equal to
   its coalesced response, #4 launched 13 times (one per G conv) per dispatch, no conv
   kernel, no plain version, a png mosaic; the ms per batch-8 forward (CUDA events);
   (e) #4 against its plain version at every 2-D shape the run and the server gave it:
   the serving shapes (f32, pixel norm on and off) as phase 3, the step's shapes of both
   phases (bf16 forward, f32 and bf16 backward) as phase 6, with the same limits, a
   sample alone bit-equal to its slot, bit-identical reruns, each shape's three times
   and bound;
16b. the quality-evidence drivers (``--only evidence``, ``saragan_tpu_torch.scripts``)
   on toy budgets (``--smoke``), phases 1 -> 2 on the card: the flagship schedule, the
   cubic schedule, the 2-D path, the five other families at phase 1 and a two-trial TPE
   study in process (counts set to 0 just before, read just after: #1 forward and dgrad,
   #2 and #4 and its backward launched, the convs through the tensor-core route only, no
   plain version), each exiting 0 with finite end-of-phase readings; the quality gates run
   on their smoke trajectories (verdicts printed, not enforced on a toy budget); then the
   preemption receipt (``--smoke``: 16³ at phase 1 alone, batch 16, 64 + 64 images), which
   runs the CLI in subprocesses: the uninterrupted run, SIGTERM in phase 1 (exit 75, one
   resume point), the requeue with --auto_resume, parameters and EMA bit-equal (the seed
   band, whose --smoke runs the flagship smoke above again in a subprocess, is left to the
   CPU tests);
   #1, #1' and #2 against their plain versions (bf16) at every conv shape of the in-process
   runs, weighted by their launches there, and #4 forward and backward at the flagship
   smoke generator's shapes as phase 6 holds them (the kernels line's ``[evidence]`` rows);
   the drivers' logs go to chiprun_out/evidence/;
17. data parallelism (``--only parallel``) on the one card, which gives no scaling number
   (NCCL refuses two ranks on one device, so two ranks run over gloo, their collectives
   through host memory):
   (a) NCCL at world size 1: the flagship step (phase 6, batch 8, bf16, flat; the mixing
   half) through the data-parallel step, bit-equal to the plain step from the same state
   and draws, with #1, #1', #2 and #4 launched as often as the plain step and phase 5
   (counts set to 0 just before, read just after), NCCL's all-reduce kernel in a profiled
   step; the ms of both steps (6 each, in turns) and of the all-reduce alone;
   (b) two gloo ranks: ``tools.profile_parallel`` through ``torch.distributed.run``: the
   DP step (8 rows a rank, 16 global) against the one-process step on the rank-major 16,
   f32 (parameters rtol 1e-4 / atol 1e-6 but for gradients under Adam's eps, gradients
   within 1e-4 of max) and bf16 (gradients no farther from the f32 step's than 1.5 times
   the one-process bf16 step's; parameters within lr / 2 of the one-process step's but
   where the f32 gradient's sign is within those errors of zero), the ranks bit-equal after
   one and after 3 more steps, ms per step per rank and of the all-reduce; the halo conv at
   the phase-6 last G conv (depth 32 split 16 + 16) through #1 against #1 on the whole
   volume within 1e-5 of max (bit-equality reported), its ms against the whole volume's;
   then the CLI with ``--horovod`` from phase 5 to 6 (32 + 32 images a phase) on two
   ranks launched as torchrun launches them: both exit 0, model_6.npz's arrays equal,
   rank 0 alone writes events, finite losses, the transport line in the log;
   (c) ``--serve_devices 2`` raises ValueError on this one-card machine; the keyed
   sampler's rows split over [cuda:0, cuda:0] bit-equal to one device's, #1 and #4
   launched;
   (d) spatial sharding on gloo ranks sharing the card: ``tools.profile_parallel --space``
   through torchrun, the flagship step (phase 6, batch 8, flat, the mixing half) with each
   volume's depth split 16 + 16 over two ranks (data 1 x space 2), f32 and bf16, against
   the one-process step from the same state and draws (f32: gradients within 1e-4 of
   max, or within ``SPACE_F32_MARGIN`` times the one-process f32 step's own distance
   from the same step with f64 activations, and the sharded f64 step within
   ``F64_GRAD_LIMIT`` of max of the one-process f64 step; parameters rtol 1e-4 / atol
   1e-6 but where the gradient is within the gradient limit of max of zero, those within
   2 lr and at most ``SPACE_LOOSE_SHARE`` of the entries; bf16: the limits of (b) at the
   margin ``BF16_SPACE_GRAD_MARGIN``),
   the ranks bit-equal after one and after 3 more steps, #1 (forward and dgrad), #2 and
   #4 launched on each rank's slab in that step (counts set to 0 just before, read just
   after; printed per rank, no plain version), the ms per step per rank and the
   exchanges' share of an instrumented step; then four ranks at phase 3, depth and height
   each split over two (space 2 x space2 2), f32 only, the same limits; then
   the CLI with ``--horovod
   --num_space_shards 2`` from phase 5 to 6 on two ranks: both exit 0, model_6.npz's
   arrays equal, rank 0 alone writes events, finite losses; #1, #1' and #2 timed at every
   conv shape of the two-rank bf16 step's slabs (the kernels line's ``[space]`` rows;
   their bounds and TFLOP/s count the work of the cropped output, not the 2 radius
   slices per exchanged axis that a halo conv's extended slab computes and drops);
   (e) the memory levers under spatial sharding (``--only parallel_space_levers``):
   ``tools.profile_parallel --single_chip_big_volume --bf16_only --lever_check 5`` on two
   gloo ranks: first the phase-5 sharded step under remat and under remat_offload bit-equal
   to the sharded plain step (f32 and bf16, every rank), then the phase-8 batch-2 preset step
   (128 x 512^2, C = 8 at the top) with depth 64 + 64, bf16, against the one-process preset
   step (``compare_states(space=True)``, the bf16 margin against the one-process f32 step),
   the ranks bit-equal, the ms, peak and parked MiB and #1 / #1' / #2 / #4 launches per
   rank; then #1, #1' and #2 at every 512^2 shape of rank 0's slabs and #4 at the slab's
   two 64 x 512^2 layers (the kernels line's ``[space,phase8]`` rows);
   (f) the other families sharded (``--only parallel_space_families``): surfgan at phase 5
   (depth 8 + 8, f32 with the f64 witness and bf16) and pgan2, pgandeep, stylegan and
   stylegan2 at phase 3 (depth 2 + 2, f32 with the witness) against one process at the
   limits of (d), ms per rank, the exchanges' share and launches per rank (#4 is pgan's
   alone); #1, #1' and #2 at every conv shape of surfgan's bf16 slabs (the
   ``[space,surfgan]`` rows); (e) and (f) print their seconds;
18. one JSON line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Each phase prints its seconds.  Details go to chiprun_out/chip_smoke.json.
``python3 chip_smoke.py --only engines`` builds and runs phase 10b alone, ``--only
big_volume`` phase 12, ``--only families`` phase 13, ``--only hpo`` phase 14, ``--only tools`` phase 15, ``--only two_d``
phase 16, ``--only evidence`` phase 16b, ``--only parallel`` phase 17, ``--only
parallel_space`` its part (d),
``--only parallel_space_levers`` (e) and ``--only parallel_space_families`` (f) (each
without the result lines), for working on it.  ``--only parallel_cards``, on a machine with two or more cards, runs phase 17 (b) with
one rank on each card over NCCL (its NVLink collectives and halo exchange) and
``--serve_devices`` over every card against one device, and (d)'s two-rank step with one
rank a card over NCCL (data cards / 2 x space 2), and nothing else.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from saragan_tpu_torch import cli, losses
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import _build
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.ops import minibatch_stddev as mb
from saragan_tpu_torch.ops.core import Ops
from saragan_tpu_torch.data import (NumpyPathDataset, get_numpy_dataset, imagenet, native,
                                    normalize_numpy, stdnormal_to_8bit_numpy)
from saragan_tpu_torch.data.imagenet import decoder_name, jpeg_decoder
from saragan_tpu_torch.metrics import fid as mfid
from saragan_tpu_torch.metrics import inception as minc
from saragan_tpu_torch.metrics import skim, swd
from saragan_tpu_torch.tools.generate import (_load_generator_params, generate,
                                              make_keyed_sampler)
from saragan_tpu_torch.tools.profile_fused import kernel_label as fused_label
from saragan_tpu_torch.tools.profile_fused import time_three_ways
from saragan_tpu_torch.tools.profile_mbstd import mbstd_inputs
from saragan_tpu_torch.tools.profile_serving import BENCH_CFG, time_ms
from saragan_tpu_torch.tools.profile_training import (HALVES, PHASE8_FINAL_SHAPE,
                                                       bench_train_config, launch_counts,
                                                       profile_one_step, real_batch,
                                                       run_steps)
from saragan_tpu_torch.tools.serve import GeneratorService, make_server
from saragan_tpu_torch.scripts import _evidence as gates
from saragan_tpu_torch.scripts.convergence_run_flagship import flagship_config
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train.step import init_train_state, make_grads_fn, make_train_step

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device memory, f32 outside
# the tensor cores (TF32 is off on both paths) and bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TRAIN_STEPS = 5

PHASE, BATCH = 6, 8
REQUESTS = [(1, 101), (3, 102), (8, 103), (8, 104)]  # (num_samples, seed)
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# the trainer through its CLI: the flagship configuration (bench.py:99-119) from phase 5
# (batch 16) into phase 6 (batch 8), 32 + 32 images per phase
TRAINER_ARGS = [
    "pgan", "<data>", "--start_shape", "(1, 1, 4, 4)", "--final_shape", "(1, 128, 512, 512)",
    "--starting_phase", "5", "--ending_phase", "6", "--latent_dim", "256",
    "--network_size", "xs", "--base_batch_size", "256", "--mixing_nimg", "32",
    "--stabilizing_nimg", "32", "--loss_fn", "wgan", "--gp_weight", "10",
    "--noise_stddev", "0", "--g_lr", "1e-3", "--d_lr", "1e-3", "--adam_beta1", "0",
    "--adam_beta2", "0.9", "--compute_dtype", "bfloat16", "--use_pallas_fusion",
    "--summary_small_every_nsteps", "16",
    "--summary_large_every_nsteps", "32", "--checkpoint_every_nsteps", "32"]
PHASE6_START = 64  # global image count at which phase 6 begins (32 + 32 at phase 5)
# the in-process trainer run (not the resume pair) also runs the metric passes: FID over
# random features, SWD, SSIM and PSNR, once per phase (every 64 images) and at each
# phase's end on the validation and test splits
METRIC_ARGS = ["--calc_metrics", "--compute_FID", "--allow_uncalibrated_fid", "--compute_swds",
               "--compute_ssims", "--compute_psnrs", "--metrics_every_nsteps", "64"]
METRIC_TAGS = ("fid", "fid_EMA", "PSNR", "ssim", "swd_mean", "fid_validation",
               "PSNR_validation", "ssim_validation", "swd_mean_validation", "fid_test")
# the big-volume phase: the flagship at phase 8 (128x512x512) under the
# single_chip_big_volume preset, at the flagship schedule's batch there
# (--base_batch_size 256 halved seven times)
BIG_PHASE, BIG_BATCH = 8, 2
BIG_STEPS = 5
BIG_SPATIAL = (128, 512, 512)
BIG_TRAINER_ARGS = [
    "pgan", "<data>", "--start_shape", "(1, 1, 4, 4)", "--final_shape", PHASE8_FINAL_SHAPE,
    "--starting_phase", "8", "--ending_phase", "8", "--latent_dim", "256",
    "--network_size", "xs", "--base_batch_size", "256", "--mixing_nimg", "4",
    "--stabilizing_nimg", "4", "--loss_fn", "wgan", "--gp_weight", "10",
    "--noise_stddev", "0", "--g_lr", "1e-3", "--d_lr", "1e-3", "--adam_beta1", "0",
    "--adam_beta2", "0.9", "--compute_dtype", "bfloat16", "--use_pallas_fusion",
    "--single_chip_big_volume", "--summary_small_every_nsteps", "4",
    "--summary_large_every_nsteps", "8", "--checkpoint_every_nsteps", "8"]
# the families phase: surfgan at the flagship's settings (bench.py:99-119 with
# architecture="surfgan") at phase 6, batch 8, and through the CLI from phase 5 (batch 16)
# into phase 6 (batch 8), 16 + 16 images per phase; the other four families one step each
# at phase 4, batch 8 (stylegan2 trains one phase)
FAMILY = "surfgan"
FAMILY_STEPS = 5
OTHER_FAMILIES = ("pgan2", "pgandeep", "stylegan", "stylegan2")
OTHER_PHASE = 4
FAMILY_REQUESTS = [(1, 201), (3, 202), (2, 203), (2, 204)]  # (num_samples, seed)
FAMILY_TRAINER_ARGS = [
    FAMILY, "<data>", "--start_shape", "(1, 1, 4, 4)", "--final_shape", "(1, 128, 512, 512)",
    "--starting_phase", "5", "--ending_phase", "6", "--latent_dim", "256",
    "--network_size", "xs", "--base_batch_size", "256", "--mixing_nimg", "16",
    "--stabilizing_nimg", "16", "--loss_fn", "wgan", "--gp_weight", "10",
    "--noise_stddev", "0", "--g_lr", "1e-3", "--d_lr", "1e-3", "--adam_beta1", "0",
    "--adam_beta2", "0.9", "--compute_dtype", "bfloat16", "--summary_small_every_nsteps", "16",
    "--summary_large_every_nsteps", "32", "--checkpoint_every_nsteps", "32",
    "--disable_grad_histograms"]
# the 2-D phase: pgan at ProGAN's published widths (the 2-D 'm' table over nine phases,
# 4^2 -> 1024^2, latent 512) through the CLI from phase 6 (128^2, 128 filters, batch 16)
# into phase 7 (256^2, 64 filters, batch 8), 32 + 32 images per phase, G on Adam and D on
# LAMB as the 2-D reference hard-wires them.  A run has log2(final / start) phases, the
# last at half the final shape (as bench.py's phase-8 step takes final 256x1024x1024), so
# nine phases ending at 1024^2 take final (3, 2048, 2048)
TWO_D_ARGS = [
    "pgan", "<data>", "--start_shape", "(3, 4, 4)", "--final_shape", "(3, 2048, 2048)",
    "--starting_phase", "6", "--ending_phase", "7", "--latent_dim", "512",
    "--network_size", "m", "--conv_kernel_size", "3", "3", "--base_batch_size", "512",
    "--mixing_nimg", "32", "--stabilizing_nimg", "32", "--loss_fn", "wgan", "--gp_weight",
    "10", "--noise_stddev", "0", "--g_lr", "1e-3", "--d_lr", "2.5e-3", "--optimizer", "Adam",
    "--d_use_different_optimizer", "--d_optimizer", "LAMB", "--weight_decay", "0.004",
    "--compute_dtype", "bfloat16", "--use_pallas_fusion", "--summary_small_every_nsteps",
    "16", "--summary_large_every_nsteps", "32", "--checkpoint_every_nsteps", "32",
    "--disable_grad_histograms"]
TWO_D_PHASES = (6, 7)
TWO_D_BATCH = {6: 16, 7: 8}
TWO_D_NIMG = 32  # images per half
TWO_D_LAST_START = 2 * TWO_D_NIMG  # global image count at which phase 7 begins
TWO_D_REQUESTS = [(1, 301), (3, 302), (8, 303), (8, 304)]  # (num_samples, seed)
FUSED_SOURCE = "saragan_tpu_torch/csrc/fused_bias_act.cu"
MBSTD_SOURCE = "saragan_tpu_torch/csrc/minibatch_stddev.cu"
STANDALONE_5 = ("standalone: no path of the JAX package runs it (the D's minibatch_stddev_layer "
                "is plain jnp, saragan_tpu/ops/pallas_kernels.py:163-168)")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def serving_shapes(cfg, phase, batch):
    """The fused-op activations and the flat-engine conv (x, w) shapes of one forward,
    in the order pgan's generator runs them (fused transitions on)."""
    ks, fs = cfg.resolved_kernel_spec(), cfg.resolved_filter_spec()

    def sp(p):
        return tuple(d * 2 ** (p - 1) for d in cfg.base_shape[1:])

    fused = [(batch, fs[0][1], *sp(1))]
    convs = [((batch, fs[0][0], *sp(1)), (*ks[0][1], fs[0][0], fs[0][1]))]
    for i in range(2, phase + 1):
        fused += [(batch, fs[i - 1][0], *sp(i)), (batch, fs[i - 1][1], *sp(i))]
        convs.append(((batch, fs[i - 1][0], *sp(i)), (*ks[i - 1][1], fs[i - 1][0], fs[i - 1][1])))
    return fused, convs


def bound(nbytes, nops, peak_flops=F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / peak_flops * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def _alone_equals_slot(fn, *batch, slot=5):
    """`fn` of sample `slot` computed alone is bit-equal to its slot of `fn` on the batch,
    for every tensor output that has a batch dimension."""
    slot = min(slot, batch[0].shape[0] - 1)
    full = fn(*batch)
    alone = fn(*(t[slot:slot + 1].contiguous() if t.ndim > 1 else t for t in batch))
    full, alone = (full, alone) if isinstance(full, tuple) else ((full,), (alone,))
    return all(torch.equal(a, f[slot:slot + 1]) for a, f in zip(alone, full) if f.ndim > 1)


def check_fused(fused_shapes, detail):
    g = torch.Generator(device="cuda").manual_seed(0)
    entry = dict(ms=0.0, device_ms=0.0, host_us=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                 t_ops=0.0, max_abs_err=0.0)
    for shape, count in Counter(fused_shapes).items():
        x = torch.randn(shape, generator=g, device="cuda")
        b = torch.randn(shape[1], generator=g, device="cuda")
        for pixelnorm in (True, False):
            y = fba.fused_bias_act_pixelnorm(x, b, 0.2, pixelnorm)
            ref = fba.bias_act_pixelnorm_plain(x, b, 0.2, pixelnorm)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            excess = (err - (1e-6 + 1e-5 * ref.abs())).max().item()
            check(excess <= 0 and torch.isfinite(y).all().item(),
                  f"fused kernel {shape} pixelnorm={pixelnorm}: tolerance exceeded by {excess}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err.max().item())
            check(_alone_equals_slot(lambda xx, bb: fba.fused_bias_act_pixelnorm(
                xx, bb, 0.2, pixelnorm), x, b),
                f"fused kernel {shape} pixelnorm={pixelnorm}: a sample alone differs from its "
                f"slot in the batch")
        t = time_three_ways(lambda: fba.fused_bias_act_pixelnorm(x, b, 0.2, True))
        plain_ms = time_ms(lambda: fba.bias_act_pixelnorm_plain(x, b, 0.2, True))
        n, c = shape[:2]
        s = x[0, 0].numel()
        # per element: bias add, select, slope multiply, square, sum, scale; per voxel
        # the mean and rsqrt.  One read of x and b, one write of y.
        b_ms, t_bytes, t_ops = bound((2 * n * c * s + c) * 4, 6 * n * c * s + 2 * n * s)
        detail.append(dict(kernel="fused_bias_act_pixelnorm", shape=list(shape), calls=count,
                           ms=t["ms"], device_ms=t["device_ms"], host_us=t["host_us"],
                           queued_ahead=t["queued_ahead"], plain_ms=plain_ms, bound_ms=b_ms))
        print(f"fused {shape} x{count}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, "
              f"host {t['host_us']:.1f} us), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms, "
              f"alone = its slot", flush=True)
        for k, v in (("ms", t["ms"]), ("device_ms", t["device_ms"]), ("host_us", t["host_us"]),
                     ("plain_ms", plain_ms), ("bound_ms", b_ms), ("t_bytes", t_bytes),
                     ("t_ops", t_ops)):
            entry[k] += count * v
    return entry


def check_conv(conv_shapes, detail):
    g = torch.Generator(device="cuda").manual_seed(1)
    entry = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0, library_ms=0.0,
                 t_flop=0.0, max_abs_err=0.0)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for xs, ws in conv_shapes:
            x = torch.randn(xs, generator=g, device="cuda")
            w = torch.randn(ws, generator=g, device="cuda") * (2.0 / (ws[3] * ws[0] * ws[1] * ws[2])) ** 0.5
            y = cf.conv3d_flat_cuda(x, w)
            again = cf.conv3d_flat_cuda(x, w)
            ref = cf.conv3d_flat_plain(x, w)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"conv kernel x{xs} w{ws}: two runs differ")
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            check(err <= 1e-4 * scale and torch.isfinite(y).all().item(),
                  f"conv kernel x{xs} w{ws}: max|err| {err} > 1e-4 * {scale}")
            plan = cf.conv_simt_plan(xs, ws)
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            lib_err = (F.conv3d(x, wt, padding="same") - ref).abs().max().item()
            ms = time_ms(lambda: cf.conv3d_flat_cuda(x, w))
            plain_ms = time_ms(lambda: cf.conv3d_flat_plain(x, w))
            library_ms = time_ms(lambda: F.conv3d(x, wt, padding="same"))
            n, c = xs[:2]
            f = ws[-1]
            vox = x[0, 0].numel()
            taps = ws[0] * ws[1] * ws[2]
            flop = 2 * n * f * c * taps * vox
            b_ms, t_bytes, t_ops = bound((n * c * vox + taps * c * f + n * f * vox) * 4, flop)
            plan_s = (f"box {plan.box}, cc {plan.cc}, ft {plan.ft}, tile {plan.vpt}x{plan.fpt}, "
                      f"{plan.threads} threads")
            detail.append(dict(kernel="conv3d_flat", route="simt", x=list(xs), w=list(ws), ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                               max_abs_err=err, library_max_abs_err=lib_err, plan=plan_s,
                               tflops=flop / ms / 1e9, share_of_bound=b_ms / ms))
            print(f"conv x{xs} w{ws}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.conv3d {library_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({'ops' if t_ops > t_bytes else 'bytes'}), {flop / ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * b_ms / ms:.1f} % of bound, err {err:.3g} of {scale:.3g}, "
                  f"bit-identical rerun; plan {plan_s}", flush=True)
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bound_ms", b_ms), ("t_bytes", t_bytes), ("t_ops", t_ops),
                         ("t_flop", flop)):
                entry[k] += v
    return entry


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"POST {body} -> {r.status}")
        return r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def serve_engine(model_path, cfg, engine):
    """Serve the checkpoint under `engine`; returns ({seed: volumes}, timings, launches)."""
    service = GeneratorService.from_checkpoint("pgan", model_path, cfg=cfg, phase=PHASE,
                                               batch_size=BATCH, device="cuda",
                                               conv_engine=engine)
    srv = make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        t0 = time.perf_counter()
        service.warmup()  # loads the kernels' libraries on first use
        warm_s = time.perf_counter() - t0
        check(_get(url + "/healthz")["status"] == "ok", "healthz")
        info = _get(url + "/info")
        check(info["conv_engine"] == engine and info["volume_shape"] == [1, 32, 128, 128],
              f"info {info}")
        batches0 = service.stats["batches"]

        # the main path: counts set to 0 just before, read just after
        zero_counts()
        results, errors = {}, []

        def client(num, seed):
            try:
                results[seed] = _post(url + "/generate", {"num_samples": num, "seed": seed})
            except Exception as e:  # noqa: BLE001 (reported by the check below)
                errors.append(f"seed {seed}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=r) for r in REQUESTS]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads), f"requests: {errors}")
        launches = {"fused": fba.fused_bias_act_pixelnorm.launches,
                    "conv": cf.conv3d_flat_cuda.launches,
                    "conv_tc": cf.launches_by_route(cf.conv3d_flat_cuda)["tc"],
                    "plain": fba.bias_act_pixelnorm_plain.calls + cf.conv3d_flat_plain.calls}
        stats = _get(url + "/stats")
        dispatches = stats["batches"] - batches0

        vols = {}
        for num, seed in REQUESTS:
            v = np.load(io.BytesIO(results[seed]))
            check(v.shape == (num, 1, 32, 128, 128) and v.dtype == np.float32,
                  f"seed {seed}: shape {v.shape} dtype {v.dtype}")
            check(np.isfinite(v).all(), f"seed {seed}: non-finite volumes")
            vols[seed] = v
        check(stats["max_requests_coalesced"] >= 2, f"no coalescing: {stats}")
        check(dispatches >= 3, f"{dispatches} dispatches for {sum(n for n, _ in REQUESTS)} samples")
        check(launches["fused"] == 11 * dispatches,
              f"{launches['fused']} fused launches for {dispatches} dispatches")
        check(launches["conv"] == (6 if engine == "flat" else 0) * dispatches,
              f"{launches['conv']} conv launches for {dispatches} dispatches ({engine})")
        check(launches["plain"] == 0, f"{launches['plain']} plain-version calls on the card")
        check(launches["conv_tc"] == 0, f"f32 serving: {launches['conv_tc']} tensor-core launches")

        # the same requests served alone are bit-equal to their coalesced responses
        for num, seed in REQUESTS:
            alone = np.load(io.BytesIO(_post(url + "/generate", {"num_samples": num, "seed": seed})))
            check(np.array_equal(alone, vols[seed]),
                  f"{engine}: seed {seed} served alone differs from its coalesced response "
                  f"by {np.abs(alone - vols[seed]).max()}")

        # steady state: device time of one batch-8 forward, and of a served dispatch
        g_params, _ = _load_generator_params(model_path, True, "cuda")
        sampler = make_keyed_sampler(cfg, PHASE, BATCH, device="cuda", conv_engine=engine)
        seeds = np.arange(BATCH, dtype=np.int32)
        forward_ms = time_ms(lambda: sampler(g_params, seeds, seeds))
        dispatch_ms = _get(url + "/stats")["bucket_ms"][str(BATCH)]
        timing = dict(forward_ms=forward_ms, dispatch_ms=dispatch_ms, warmup_s=warm_s,
                      burst_s=burst_s, dispatches=dispatches,
                      max_requests_coalesced=stats["max_requests_coalesced"],
                      padded_slots=stats["padded_slots"])
        print(f"serve[{engine}]: {dispatches} dispatches for {len(REQUESTS)} concurrent requests, "
              f"launches {launches}, forward {forward_ms:.3f} ms/batch-8 (CUDA events), "
              f"served dispatch {dispatch_ms} ms (host clock, incl. fetch), "
              f"burst {burst_s:.3f} s", flush=True)
        return vols, timing, launches
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()
        thread.join(timeout=30)


def _kernel_label(mangled):
    """A ptxas entry name shortened to the kernel and its template arguments."""
    if "fused_" in mangled:
        return fused_label(mangled)
    for name in ("conv3d_fwd_v2_tc_kernel", "conv3d_fwd_v2_kernel", "channels_last_kernel",
                 "conv3d_fwd_tc_kernel", "wgrad_tc_partial_kernel", "wgrad_tc_reduce_kernel",
                 "wgrad_partial_kernel", "wgrad_reduce_kernel", "conv3d_fwd_kernel"):
        if name in mangled:
            return f"{name}<{','.join(re.findall(r'Li(\d+)E', mangled.split(name, 1)[1]))}>"
    return mangled


def tensor_core_instructions():
    """{library: HMMA instructions in its SASS} for the bf16 conv libraries (cuobjdump,
    from nvcc's toolkit)."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    for name in ("conv3d_fwd_tc", "conv3d_wgrad_tc", "conv3d_fwd_v2_tc"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = sum(1 for line in sass.splitlines() if "HMMA" in line)
    return counts


def zero_counts():
    """Every launch and plain-call count to 0."""
    for fn in (cf.conv3d_flat_cuda, cf.conv3d_flat_wgrad_cuda, cf.conv3d_flat_v2_cuda):
        fn.launches = 0
        fn.by_shape.clear()
    fba.fused_bias_act_pixelnorm.launches = 0
    fba.fused_bias_act_pixelnorm_grad.launches = 0
    mb.minibatch_stddev_stat_cuda.launches = 0
    for fn in (cf.conv3d_flat_plain, cf.conv3d_flat_wgrad_plain, cf.conv3d_flat_v2_plain,
               fba.bias_act_pixelnorm_plain, fba.bias_act_pixelnorm_grad_plain,
               mb.minibatch_stddev_stat_plain):
        fn.calls = 0


def read_counts():
    by_role = Counter()
    for (role, *_), n in cf.conv3d_flat_cuda.by_shape.items():
        by_role[role] += n
    conv_routes = cf.launches_by_route(cf.conv3d_flat_cuda)
    wgrad_routes = cf.launches_by_route(cf.conv3d_flat_wgrad_cuda)
    return dict(forward=by_role["forward"], dgrad=by_role["dgrad"],
                wgrad=cf.conv3d_flat_wgrad_cuda.launches,
                conv_tc=conv_routes["tc"], conv_simt=conv_routes["simt"],
                wgrad_tc=wgrad_routes["tc"], wgrad_simt=wgrad_routes["simt"],
                fused=fba.fused_bias_act_pixelnorm.launches,
                fused_grad=fba.fused_bias_act_pixelnorm_grad.launches,
                v2=cf.conv3d_flat_v2_cuda.launches,
                mbstd=mb.minibatch_stddev_stat_cuda.launches,
                plain=(cf.conv3d_flat_plain.calls + cf.conv3d_flat_wgrad_plain.calls
                       + fba.bias_act_pixelnorm_plain.calls
                       + fba.bias_act_pixelnorm_grad_plain.calls + cf.conv3d_flat_v2_plain.calls
                       + mb.minibatch_stddev_stat_plain.calls))


def _moved(a, b):
    return any(not torch.equal(a[k], b[k]) for k in a)


def train_engine(cfg, engine, state0, opts, real):
    """The flagship step under `engine` from `state0`, both halves.  Returns (timing
    rows, per-step launches, per-shape launch counts of the timed steps)."""
    arch = get_architecture("pgan")
    rng = torch.Generator(device="cuda").manual_seed(1)
    state, rows, launches = state0, {}, {}
    conv_shapes, wgrad_shapes = Counter(), Counter()
    for half, static_alpha, alpha in HALVES:
        step = make_train_step(arch, cfg, PHASE, *opts, static_alpha=static_alpha,
                               conv_engine=engine)
        zero_counts()
        state, _, _ = run_steps(step, state, real, rng, alpha, 1)  # warm-up
        warm = read_counts()
        # the main path: counts set to 0 just before, read just after
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        state, ms, metrics = run_steps(step, state, real, rng, alpha, TRAIN_STEPS)
        counts = read_counts()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        conv_shapes.update(cf.conv3d_flat_cuda.by_shape)
        wgrad_shapes.update(cf.conv3d_flat_wgrad_cuda.by_shape)
        profiled = None
        if engine == "flat":  # the kernels one more step runs and the host's launch calls
            state, prof = profile_one_step(step, state, real, rng, alpha)
            profiled = {k: prof[k] for k in ("kernels", "launch_calls", "device_ms",
                                             "profiled_step_ms")}
        losses = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
        check(all(math.isfinite(v) for row in losses for v in row),
              f"train[{engine}] {half}: non-finite losses {losses}")
        check(counts["plain"] == 0, f"train[{engine}] {half}: {counts['plain']} plain-version "
                                    f"calls on the card")
        for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad"):
            check(counts[k] == TRAIN_STEPS * warm[k],
                  f"train[{engine}] {half}: {counts[k]} {k} launches in {TRAIN_STEPS} steps, "
                  f"{warm[k]} in the warm-up step")
        # the fused op's backward: one kernel call for each forward launch, 11 per step
        check(warm["fused_grad"] == warm["fused"] == 11,
              f"train[{engine}] {half}: fused launches {warm['fused']}, backward "
              f"{warm['fused_grad']} per step")
        if engine == "flat":
            check(min(warm[k] for k in ("forward", "dgrad", "wgrad", "fused")) > 0,
                  f"train[flat] {half}: a kernel was not launched: {warm}")
            # bf16: every conv through the tensor-core kernels, none through the CUDA cores
            check(counts["conv_tc"] == counts["forward"] + counts["dgrad"]
                  and counts["wgrad_tc"] == counts["wgrad"]
                  and counts["conv_simt"] == counts["wgrad_simt"] == 0,
                  f"train[flat] {half}: routes {counts}")
        else:
            check(warm["forward"] == warm["dgrad"] == warm["wgrad"] == 0 and warm["fused"] > 0,
                  f"train[direct] {half}: launches {warm}")
        rows[half] = dict(step_ms=statistics.median(ms), step_ms_all=ms, peak_mib=peak_mib,
                          losses=losses, profiled=profiled)
        launches[half] = dict(per_step={k: warm[k] for k in (
            "forward", "dgrad", "wgrad", "fused", "fused_grad", "conv_tc", "conv_simt",
            "wgrad_tc", "wgrad_simt")}, total=counts)
        print(f"train[{engine}] {half}: {statistics.median(ms):.2f} ms/step (median of "
              f"{TRAIN_STEPS}, CUDA events; all {[round(v, 2) for v in ms]}), peak "
              f"{peak_mib:.0f} MiB, launches per step {launches[half]['per_step']}, "
              f"losses {losses[-1]}; profiled step {profiled}", flush=True)
    for part in ("g_params", "d_params", "ema"):
        check(_moved(getattr(state, part), getattr(state0, part)),
              f"train[{engine}]: {part} did not move")
    return rows, launches, (conv_shapes, wgrad_shapes)


def _conv_bound(n, c, f, taps, vox, dtype, c_vox=None, f_vox=None):
    """The bound of a conv whose C-channel side has `c_vox` voxels and F-channel side
    `f_vox` (both `vox` by default); its operations count the smaller (a halo conv's
    cropped output)."""
    c_vox, f_vox = c_vox or vox, f_vox or vox
    esize = 2 if dtype == torch.bfloat16 else 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    # x and w (or dy) read once, y (or dw) written once
    return bound((n * c * c_vox + taps * c * f + n * f * f_vox) * esize,
                 2 * n * f * c * taps * min(c_vox, f_vox), peak)


def _needed_vox(spatial, kernel, role, crops):
    """(C side, F side) voxels that a conv at `spatial` must move: the whole volume, or at
    a halo conv's extended slab (`crops`: {(spatial, kernel): [depth, height] slices
    cropped at each end}) the cropped output's on the side that holds the output (the
    forward's y, the dgrad's input dy, the wgrad's dy)."""
    vox = math.prod(spatial)
    radii = (crops or {}).get((tuple(spatial), tuple(kernel)))
    if not radii:
        return vox, vox
    inner = (spatial[0] - 2 * radii[0]) * (spatial[1] - 2 * radii[1]) * spatial[2]
    return (inner, vox) if role == "dgrad" else (vox, inner)


def _add(entry, weight, t):
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops", "t_flop"):
        entry[k] += weight * t[k]
    entry["launches_per_step"] += weight
    entry["max_abs_err"] = max(entry["max_abs_err"], t["err"])
    entry["max_rel_err"] = max(entry["max_rel_err"], t["err"] / max(t["scale"], 1e-30))


def _rate_line(t):
    return (f", {t['t_flop'] / t['ms'] / 1e9:.1f} TFLOP/s, {100 * t['bound_ms'] / t['ms']:.1f} % "
            f"of bound")


def check_train_convs(conv_shapes, wgrad_shapes, steps, detail,
                      dtypes=(torch.float32, torch.bfloat16), crops=None):
    """Forward/dgrad and wgrad kernels at every (shape, role) the train step launched, in
    f32 (CUDA cores) and bf16 (tensor cores), or the `dtypes` given.  Returns {(kind,
    dtype name): summed per-step entry}; each shape's numbers count as often as one step
    launches it.  `crops` (``_needed_vox``): the halo convs' extended slabs, whose bounds
    and operations count the cropped output."""
    g = torch.Generator(device="cuda").manual_seed(2)
    limits = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    entries, timed = {}, {}

    def entry(kind, dtype):
        return entries.setdefault((kind, str(dtype).split(".")[-1]), dict(
            ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0,
            t_flop=0.0, max_abs_err=0.0, max_rel_err=0.0, launches_per_step=0.0))

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for (role, xs, ws, _), count in sorted(conv_shapes.items(), key=str):
            for dtype in dtypes:
                key = (xs, ws, dtype)
                if key not in timed:
                    x = torch.randn(xs, generator=g, device="cuda").to(dtype)
                    fan_in = ws[0] * ws[1] * ws[2] * ws[3]
                    w = torch.randn(ws, generator=g, device="cuda") * (2.0 / fan_in) ** 0.5
                    w = w.to(dtype)
                    y = cf.conv3d_flat_cuda(x, w, role)
                    again = cf.conv3d_flat_cuda(x, w, role)
                    ref = cf.conv3d_flat_plain(x, w)
                    torch.cuda.synchronize()
                    check(torch.equal(y, again), f"conv {dtype} x{xs} w{ws}: two runs differ")
                    err = (y.float() - ref.float()).abs().max().item()
                    scale = ref.float().abs().max().item()
                    check(err <= limits[dtype] * scale and torch.isfinite(y).all().item(),
                          f"conv {dtype} x{xs} w{ws}: max|err| {err} > {limits[dtype]} * {scale}")
                    del y, again, ref
                    wt = w.permute(4, 3, 0, 1, 2).contiguous()
                    n, c = xs[:2]
                    c_vox, f_vox = _needed_vox(xs[2:], ws[:3], role, crops)
                    b_ms, t_bytes, t_ops = _conv_bound(n, c, ws[-1], ws[0] * ws[1] * ws[2],
                                                       math.prod(xs[2:]), dtype, c_vox, f_vox)
                    t = dict(ms=time_ms(lambda: cf.conv3d_flat_cuda(x, w, role), reps=5, warmup=1),
                             plain_ms=time_ms(lambda: cf.conv3d_flat_plain(x, w), reps=3, warmup=1),
                             library_ms=time_ms(lambda: F.conv3d(x, wt, padding="same"), reps=5,
                                                warmup=1),
                             bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops,
                             t_flop=2 * n * ws[-1] * c * ws[0] * ws[1] * ws[2] * min(c_vox, f_vox),
                             err=err, scale=scale)
                    timed[key] = t
                    detail.append(dict(kernel="conv3d_flat", route=cf.conv_route(dtype),
                                       dtype=str(dtype), x=list(xs), w=list(ws),
                                       tflops=t["t_flop"] / t["ms"] / 1e9,
                                       share_of_bound=b_ms / t["ms"], **t))
                    print(f"conv {str(dtype)[6:]} x{xs} w{ws}: kernel {t['ms']:.4f} ms, plain "
                          f"{t['plain_ms']:.4f}, F.conv3d {t['library_ms']:.4f}, bound "
                          f"{b_ms:.4f} ({'ops' if t_ops > t_bytes else 'bytes'}), err "
                          f"{err:.3g} of {scale:.3g}, bit-identical rerun{_rate_line(t)}",
                          flush=True)
                _add(entry(role, dtype), count / steps, timed[key])

        for (xs, dys, k, _), count in sorted(wgrad_shapes.items(), key=str):
            for dtype in dtypes:
                x = torch.randn(xs, generator=g, device="cuda").to(dtype)
                dy = torch.randn(dys, generator=g, device="cuda").to(dtype)
                dw = cf.conv3d_flat_wgrad_cuda(x, dy, k)
                again = cf.conv3d_flat_wgrad_cuda(x, dy, k)
                ref = cf.conv3d_flat_wgrad_plain(x, dy, k)
                w0 = torch.zeros((dys[1], xs[1], *k), dtype=dtype, device="cuda")
                pad = [kk // 2 for kk in k]

                def library():
                    return torch.ops.aten.convolution_backward(
                        dy, x, w0, None, [1, 1, 1], pad, [1, 1, 1], False, [0, 0, 0], 1,
                        [False, True, False])[1]

                lib_dw = library().permute(2, 3, 4, 1, 0).float()
                lib_err = (lib_dw - ref.float()).abs().max().item()
                torch.cuda.synchronize()
                check(torch.equal(dw, again), f"wgrad {dtype} x{xs} dy{dys}: two runs differ")
                err = (dw.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                check(err <= limits[dtype] * scale and torch.isfinite(dw).all().item(),
                      f"wgrad {dtype} x{xs} dy{dys}: max|err| {err} > {limits[dtype]} * {scale}")
                n, c = xs[:2]
                c_vox, f_vox = _needed_vox(xs[2:], k, "wgrad", crops)
                b_ms, t_bytes, t_ops = _conv_bound(n, c, dys[1], math.prod(k), math.prod(xs[2:]),
                                                   dtype, c_vox, f_vox)
                t = dict(ms=time_ms(lambda: cf.conv3d_flat_wgrad_cuda(x, dy, k), reps=5, warmup=1),
                         plain_ms=time_ms(lambda: cf.conv3d_flat_wgrad_plain(x, dy, k), reps=3,
                                          warmup=1),
                         library_ms=time_ms(library, reps=5, warmup=1),
                         bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops,
                         t_flop=2 * n * dys[1] * c * math.prod(k) * min(c_vox, f_vox),
                         err=err, scale=scale)
                detail.append(dict(kernel="conv3d_wgrad", route=cf.conv_route(dtype),
                                   dtype=str(dtype), x=list(xs), dy=list(dys), kernel_size=list(k),
                                   library_max_abs_err=lib_err, tflops=t["t_flop"] / t["ms"] / 1e9,
                                   share_of_bound=b_ms / t["ms"], **t))
                print(f"wgrad {str(dtype)[6:]} x{xs} dy{dys} k{k}: kernel {t['ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f}, convolution_backward {t['library_ms']:.4f}, bound "
                      f"{b_ms:.4f} ({'ops' if t_ops > t_bytes else 'bytes'}), err {err:.3g} of "
                      f"{scale:.3g} (library {lib_err:.3g}), bit-identical rerun"
                      f"{_rate_line(t)}", flush=True)
                _add(entry("wgrad", dtype), count / steps, t)
    return entries


def _gb_tol(gx):
    """Per channel: gb sums N * S terms, so two f32 orders of that sum differ by a
    multiple of eps * ||gx_c||_2, not of |gb_c|: 1e-5 * ||gx_c||_2."""
    return 1e-5 * gx.double().square().sum([0, *range(2, gx.ndim)]).sqrt()


def _gx_terms(x, b, gy):
    """Per element, |r g| + |a r^3 s / C|, the two terms whose difference is gx (f32): its
    rounding error scales with them, not with |gx|, which can be near 0 between them."""
    a = x.float() + b.reshape((1, -1) + (1,) * (x.ndim - 2))
    a = torch.where(a >= 0, a, 0.2 * a)
    g = gy.float()
    r = torch.rsqrt(a.square().mean(dim=1, keepdim=True) + 1e-8)
    s = (g * a).sum(dim=1, keepdim=True)
    return (r * g).abs() + (a * r.pow(3) * s / x.shape[1]).abs()


def _check_grad(name, gx, gb, ref_gx, ref_gb, dtype, terms):
    """The backward kernel's (gx, gb) against a reference's; `terms` from ``_gx_terms``.
    Returns the largest errors (gx, gb)."""
    ex = (gx.float() - ref_gx.float()).abs()
    eb = (gb - ref_gb).abs()
    if dtype == torch.float32:
        over_x = (ex - (1e-6 + 1e-5 * torch.maximum(ref_gx.abs(), terms))).max().item()
        over_b = (eb.double() - (1e-5 * ref_gb.abs().double() + _gb_tol(gx))).max().item()
        check(over_x <= 0 and over_b <= 0,
              f"{name}: tolerance exceeded by {over_x} (gx) / {over_b} (gb)")
    else:
        check(ex.max().item() <= 1e-2 * ref_gx.float().abs().max().item()
              and eb.max().item() <= 1e-2 * ref_gb.abs().max().item(),
              f"{name}: max|err| {ex.max().item()} (gx), {eb.max().item()} (gb)")
    return ex.max().item(), eb.max().item()


def count_kernels(fn):
    """{kernels, launch_calls} of one call of `fn`, by torch.profiler (``launch_counts``).
    The host idles 20 ms before and after the call inside the trace, so that device events
    placed a little off the call on the host's clock stay in the trace's window: a bare
    trace of the backward kernel's sub-millisecond call, late in this script, once showed
    none of its kernels (its launch calls are host events and cannot fall outside)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    kernels, launch_calls = launch_counts(prof)
    return dict(kernels=kernels, launch_calls=launch_calls)


def check_train_fused(fused_shapes, detail):
    """The fused op at every shape the train step runs it with: the forward kernel in bf16
    (the step's dtype) against its plain version; the backward kernel in f32 and bf16
    against its plain version and against autograd of the reference's oracle (what the
    backward computed before it had a kernel), gx and gb bit-identical on a rerun.  Times
    (bf16): both kernels, their plain versions, the oracle's autograd and the
    autograd.Function's backward.  Returns (forward entry, backward entry), each summed
    over the step's launches."""
    g = torch.Generator(device="cuda").manual_seed(3)
    fwd = dict(ms=0.0, device_ms=0.0, host_us=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
               t_ops=0.0, max_abs_err=0.0)
    bwd = dict(ms=0.0, device_ms=0.0, host_us=0.0, plain_ms=0.0, oracle_autograd_ms=0.0,
               function_backward_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0, max_abs_err=0.0,
               gb_max_abs_err=0.0, kernels_per_call={})
    for shape, count in Counter(fused_shapes).items():
        x32 = torch.randn(shape, generator=g, device="cuda")
        b = torch.randn(shape[1], generator=g, device="cuda")
        gy32 = torch.randn(shape, generator=g, device="cuda")
        x, gy = x32.bfloat16(), gy32.bfloat16()
        y = fba.fused_bias_act_pixelnorm(x, b, 0.2, True)
        ref = fba.bias_act_pixelnorm_plain(x, b, 0.2, True)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        check(err <= 1e-2 * ref.float().abs().max().item() and torch.isfinite(y).all().item(),
              f"fused bf16 {shape}: max|err| {err}")
        fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        check(_alone_equals_slot(lambda xx, bb: fba.fused_bias_act_pixelnorm(xx, bb, 0.2, True),
                                 x, b), f"fused bf16 {shape}: a sample alone differs from its slot")
        errs = {}
        for dtype, xd, gyd in ((torch.float32, x32, gy32), (torch.bfloat16, x, gy)):
            gx, gb = fba.fused_bias_act_pixelnorm_grad(xd, b, gyd, 0.2, True)
            gx2, gb2 = fba.fused_bias_act_pixelnorm_grad(xd, b, gyd, 0.2, True)
            plain = fba.bias_act_pixelnorm_grad_plain(xd, b, gyd, 0.2, True)
            xa, ba = xd.clone().requires_grad_(True), b.clone().requires_grad_(True)
            oracle = torch.autograd.grad(fba._oracle(xa, ba, 0.2, True), (xa, ba), gyd)
            torch.cuda.synchronize()
            check(torch.equal(gx, gx2) and torch.equal(gb, gb2),
                  f"fused backward {dtype} {shape}: two runs differ")
            check(torch.isfinite(gx).all().item() and torch.isfinite(gb).all().item(),
                  f"fused backward {dtype} {shape}: not finite")
            check(_alone_equals_slot(lambda xx, bb, gg: fba.fused_bias_act_pixelnorm_grad(
                xx, bb, gg, 0.2, True), xd, b, gyd),
                f"fused backward {dtype} {shape}: gx of a sample alone differs from its slot")
            terms = _gx_terms(xd, b, gyd)
            for name, (rgx, rgb) in (("plain", plain), ("oracle autograd", oracle)):
                errs[(str(dtype)[6:], name)] = _check_grad(
                    f"fused backward {dtype} {shape} vs {name}", gx, gb, rgx, rgb, dtype, terms)
            del terms
            if dtype == torch.bfloat16:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], errs[("bfloat16", "plain")][0])
                bwd["gb_max_abs_err"] = max(bwd["gb_max_abs_err"], errs[("bfloat16", "plain")][1])
        xb = x.clone().requires_grad_(True)
        yb = fba.bias_act_pixelnorm(xb, b)
        xo, bo = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        yo = fba._oracle(xo, bo, 0.2, True)
        if not bwd["kernels_per_call"]:
            # the backward before this kernel (the oracle recomputed, then its autograd)
            # against this one (one launch: gx, and gb finished by the last block)
            bwd["kernels_per_call"] = dict(
                oracle_backward=count_kernels(lambda: torch.autograd.grad(
                    fba._oracle(xo, bo, 0.2, True), (xo, bo), gy)),
                kernel=count_kernels(
                    lambda: fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)))
            print(f"fused backward kernels per call: {bwd['kernels_per_call']}", flush=True)
            check(bwd["kernels_per_call"]["kernel"]["launch_calls"] == 1,
                  f"fused backward: {bwd['kernels_per_call']['kernel']} per call, not 1 launch")
        t = dict(**time_three_ways(lambda: fba.fused_bias_act_pixelnorm(x, b, 0.2, True)),
                 plain_ms=time_ms(lambda: fba.bias_act_pixelnorm_plain(x, b, 0.2, True)))
        tb = dict(**time_three_ways(lambda: fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)),
                  plain_ms=time_ms(lambda: fba.bias_act_pixelnorm_grad_plain(x, b, gy, 0.2, True)),
                  oracle_autograd_ms=time_ms(lambda: torch.autograd.grad(
                      yo, (xo, bo), gy, retain_graph=True)),
                  function_backward_ms=time_ms(lambda: torch.autograd.grad(
                      yb, xb, gy, retain_graph=True)))
        n, c = shape[:2]
        s = math.prod(shape[2:])
        t["bound_ms"], t["t_bytes"], t["t_ops"] = bound(
            (2 * n * c * s) * 2 + c * 4, 6 * n * c * s + 2 * n * s, BF16_FLOPS)
        # x and gy read, gx written (bf16), b read and gb written (f32); per element about
        # 14 operations (bias, slope, the two channel sums, ga, gx, the gb sum)
        tb["bound_ms"], tb["t_bytes"], tb["t_ops"] = bound(
            (3 * n * c * s) * 2 + 2 * c * 4, 14 * n * c * s, BF16_FLOPS)
        detail.append(dict(kernel="fused_bias_act_pixelnorm", dtype="bfloat16", shape=list(shape),
                           calls=count, max_abs_err=err, **t))
        detail.append(dict(kernel="fused_bias_act_pixelnorm_grad", shape=list(shape),
                           calls=count, errors={f"{k[0]} vs {k[1]}": v for k, v in errs.items()},
                           **tb))
        print(f"fused bf16 {shape} x{count}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms, host {t['host_us']:.1f} us), plain {t['plain_ms']:.4f}, "
              f"bound {t['bound_ms']:.4f}, err {err:.3g}; backward kernel {tb['ms']:.4f} ms "
              f"(device {tb['device_ms']:.4f} ms, host {tb['host_us']:.1f} us), "
              f"plain {tb['plain_ms']:.4f}, oracle autograd {tb['oracle_autograd_ms']:.4f}, "
              f"Function backward {tb['function_backward_ms']:.4f}, bound {tb['bound_ms']:.4f}, "
              f"max|err| (gx, gb) {errs}, bit-identical rerun, alone = its slot", flush=True)
        for entry, times in ((fwd, t), (bwd, tb)):
            for k, v in times.items():
                if k != "queued_ahead":
                    entry[k] += count * v
    return fwd, bwd


def compare_engines_f32(state0, real):
    """One f32 gradient computation of the step under each engine, from one state and
    one set of pre-drawn z and gamma; `flat` runs the CUDA-core convs.  Returns the
    agreement and the `flat` run's launches."""
    cfg = bench_train_config(PHASE, BATCH, compute_dtype="float32")
    arch = get_architecture("pgan")
    draws = losses.draw_inputs(torch.Generator(device="cuda").manual_seed(4), BATCH,
                               cfg.latent_dim, real.shape[1:], torch.float32, "cuda")
    res, launches = {}, {}
    for engine in ("flat", "direct"):
        # a main path of the f32 kernels: counts set to 0 just before, read just after
        zero_counts()
        grads_fn = make_grads_fn(arch, cfg, PHASE, static_alpha=None, conv_engine=engine)
        (gg, dg), out = grads_fn(state0.g_params, state0.d_params, real, draws, 0.5)
        torch.cuda.synchronize()
        counts = read_counts()
        launches[engine] = counts
        check(counts["plain"] == 0, f"f32 step [{engine}]: plain versions ran")
        convs = counts["forward"] + counts["dgrad"] + counts["wgrad"]
        check(convs > 0 if engine == "flat" else convs == 0, f"f32 step [{engine}]: {counts}")
        check(counts["conv_tc"] == counts["wgrad_tc"] == 0,
              f"f32 step [{engine}]: tensor-core launches {counts}")
        res[engine] = ({**gg, **dg}, out)
    (ga, oa), (gb, ob) = res["flat"], res["direct"]
    loss_rel = {}
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        a, b = getattr(oa, name).item(), getattr(ob, name).item()
        loss_rel[name] = abs(a - b) / max(abs(b), 1e-30)
        check(abs(a - b) <= 1e-3 * abs(b) + 1e-6, f"f32 {name}: flat {a} vs direct {b}")
    worst = (0.0, None)
    for k, b in gb.items():
        scale = b.abs().max().item()
        err = (ga[k] - b).abs().max().item()
        check(err <= 1e-3 * scale, f"f32 gradient {k}: max|flat - direct| {err} > 1e-3 * {scale}")
        if scale > 0:
            worst = max(worst, (err / scale, k))
    print(f"f32 step flat vs direct: loss rel diffs {loss_rel}, worst gradient "
          f"max|diff|/max|g| {worst[0]:.3g} ({worst[1]}) over {len(gb)} tensors", flush=True)
    check(launches["flat"]["conv_simt"] == launches["flat"]["forward"] + launches["flat"]["dgrad"]
          and launches["flat"]["wgrad_simt"] == launches["flat"]["wgrad"] > 0
          and launches["flat"]["fused_grad"] == launches["flat"]["fused"] > 0,
          f"f32 step [flat]: launches {launches['flat']}")
    del ga, gb, res
    # the f32 gradient computation under flat, the CLI's default dtype and engine on the card
    grads_fn = make_grads_fn(arch, cfg, PHASE, static_alpha=None, conv_engine="flat")
    flat_ms = time_ms(lambda: grads_fn(state0.g_params, state0.d_params, real, draws, 0.5),
                      reps=5, warmup=1)
    print(f"f32 gradient computation under flat (phase 6, batch 8): {flat_ms:.2f} ms (median of "
          f"5 after a warm-up, CUDA events)", flush=True)
    return dict(loss_rel=loss_rel, worst_grad_rel=worst[0], worst_grad=worst[1],
                flat_launches=launches["flat"], flat_grads_ms=flat_ms)


def write_dataset(root: Path):
    """A seeded npy pyramid: 16 volumes of 16x64x64 (phase 5) and 16 of 32x128x128
    (phase 6), f32, about 36 MB."""
    rng = np.random.default_rng(0)
    for size, depth in ((64, 16), (128, 32)):
        d = root / f"{size}x{size}"
        d.mkdir(parents=True)
        for i in range(16):
            np.save(d / f"{i:03d}.npy",
                    rng.standard_normal((depth, size, size), dtype=np.float32))


def trainer_args(data: Path, logdir: Path, *extra):
    return [str(data) if a == "<data>" else a for a in TRAINER_ARGS] + [
        "--logdir", str(logdir), *extra]


def _events(logdir: Path):
    with open(logdir / "events.jsonl") as f:
        return [json.loads(line) for line in f]


# the random-feature width of the trainer's and the HPO study's metric passes (2048 until
# the script neared its time limit: a 2048-d FID's matrix square root takes 12-26 s on the
# host, and those runs take about 16 of them); the metrics phase keeps 2048
SMOKE_FID_DIM = 512


@contextlib.contextmanager
def narrow_fid_features():
    """The metric callbacks built inside (``make_metrics_callback``) on ``SMOKE_FID_DIM``-wide
    random features where they would take the 2048-wide ones (no Inception weights)."""
    import importlib

    # the module, not the package's function of the same name
    sm = importlib.import_module("saragan_tpu_torch.metrics.save_metrics")
    saved = sm.default_extractor

    def narrow(allow_uncalibrated=False, npz_path=None, device=None):
        ext = saved(allow_uncalibrated=allow_uncalibrated, npz_path=npz_path, device=device)
        if isinstance(ext, mfid.RandomConvFeatures):
            return mfid.RandomConvFeatures(out_dim=SMOKE_FID_DIM, device=device)
        return ext

    sm.default_extractor = narrow
    try:
        yield
    finally:
        sm.default_extractor = saved


def run_trainer(data: Path, logdir: Path):
    """The trainer through ``cli.main``, in process, with the metric passes
    (``METRIC_ARGS``), counts set to 0 just before and read just after.  Returns (report,
    launches)."""
    zero_counts()
    tee = _Tee(sys.stdout, re.compile(r"Input pipeline"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee), narrow_fid_features():
        cli.main(trainer_args(data, logdir, *METRIC_ARGS))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["plain"] == 0, f"trainer: {counts['plain']} plain-version calls on the card")
    pipeline_log = [line for _, line in tee.hits]
    check(len(pipeline_log) == 2 and all("native C++ prefetcher" in line for line in pipeline_log),
          f"trainer: the log does not name the native prefetcher: {pipeline_log}")
    for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad"):
        check(counts[k] > 0, f"trainer: kernel {k} not launched ({counts})")
    check(counts["conv_simt"] == counts["wgrad_simt"] == 0
          and counts["conv_tc"] == counts["forward"] + counts["dgrad"]
          and counts["wgrad_tc"] == counts["wgrad"], f"trainer (bf16): routes {counts}")
    for p in (5, 6):
        check((logdir / f"model_{p}.npz").is_file(), f"trainer: model_{p}.npz not written")
    # phase 6 restored every phase-5 name bit for bit, and its mixing half kept them frozen:
    # the cadence checkpoint after the mixing half still holds model_5's values
    # (phase 5's own fade-in layers from phase 4, *_rgb_4, are not part of phase 6)
    p5, _, _ = ckpt.load_params(str(logdir / "model_5.npz"), "cpu")
    c6, _, _ = ckpt.load_params(str(logdir / "model_6_ckpt_96.npz"), "cpu")
    shared = [k for k in p5 if k in c6]
    check(all("_rgb_4/" in k for k in p5 if k not in c6) and len(shared) > 0.9 * len(p5),
          f"trainer: phase 6 lacks names of model_5: {sorted(set(p5) - set(c6))}")
    check(all(torch.equal(c6[k], p5[k]) for k in shared),
          "trainer: phase 6 did not keep model_5's weights through the frozen mixing half")

    events = _events(logdir)
    engines = [e["text"] for e in events if e["tag"] == "config/conv_engine"]
    check(engines == ["flat"], f"trainer without --conv_engine on the card: engine {engines}")
    pipelines = [e["text"] for e in events if e["tag"] == "config/input_pipeline"]
    check(pipelines == ["native", "native"], f"trainer: input pipelines {pipelines}")
    report = dict(wall_s=wall_s, launches=counts, conv_engine=engines[0], phases={},
                  input_pipeline=pipelines[0])
    for phase, lo, hi in ((5, 0, PHASE6_START), (6, PHASE6_START, 10 ** 9)):
        ev = [e for e in events if lo <= e["step"] < hi]
        for tag in ("Loss/d_loss", "Loss/g_loss", "Loss/gp"):
            vals = [e["value"] for e in ev if e["tag"] == tag]
            check(vals and all(math.isfinite(v) for v in vals),
                  f"trainer phase {phase}: {tag} {vals}")
        check(any(e.get("hist") for e in ev), f"trainer phase {phase}: no histogram event")
        row = {}
        # a summary step (local step % 16 < batch) runs the histogram variant; at batch 16
        # every phase-5 step is one
        batch = 16 if phase == 5 else 8
        for half in ("mixing", "stabilizing"):
            timed = [e for e in ev if e["tag"] == f"Timing/step_ms_{half}"]
            check(len(timed) >= 2, f"trainer phase {phase} {half}: {len(timed)} timed steps")
            ms = [e["value"] for e in timed]
            row[f"{half}_ms_per_step"] = statistics.median(ms[1:])
            row[f"{half}_ms_all"] = ms
            # steps without a summary, to hold against the bare step's same half
            plain = [e["value"] for e in timed[1:] if (e["step"] - lo) % 16 >= batch]
            row[f"{half}_plain_ms"] = statistics.median(plain) if plain else None
        # img/s and the phase's peak are written after a step, at the advanced count
        after = [e for e in events if lo < e["step"] <= hi]
        img_s = [e["value"] for e in after if e["tag"] == "img_s" and e["value"] > 0]
        row["img_s"] = img_s[-1] if img_s else None
        peak = [e["value"] for e in after if e["tag"] == "memory/phase_peak_bytes"]
        check(len(peak) == 1, f"trainer phase {phase}: peak memory events {peak}")
        row["peak_mib"] = peak[0] / 2 ** 20
        # the metric passes: their tags, and the ms per step with their host time spread
        # over the phase's steps against the steps alone
        for tag in METRIC_TAGS:
            vals = [e["value"] for e in after if e["tag"] == tag]
            check(vals and all(math.isfinite(v) for v in vals),
                  f"trainer phase {phase}: metric {tag} {vals}")
        row["metrics"] = {tag: [e["value"] for e in after if e["tag"] == tag][-1]
                          for tag in METRIC_TAGS}
        metric_s = [e["value"] for e in after if e["tag"] == "Timing/metrics_s"]
        steps = [e["value"] for e in ev if e["tag"].startswith("Timing/step_ms_")]
        row["metric_passes_s"] = metric_s
        row["ms_per_step_without_metrics"] = statistics.median(steps)
        row["ms_per_step_with_metrics"] = (sum(steps) + 1e3 * sum(metric_s)) / len(steps)
        row["input_wait_ms"] = [e["value"] for e in after
                                if e["tag"] == "Timing/input_wait_ms"][0]
        report["phases"][phase] = row
        print(f"trainer phase {phase}: mixing {row['mixing_ms_per_step']:.2f} ms/step, "
              f"stabilizing {row['stabilizing_ms_per_step']:.2f} ms/step (median after the "
              f"first, CUDA events; all {[round(v, 2) for v in row['mixing_ms_all']]} / "
              f"{[round(v, 2) for v in row['stabilizing_ms_all']]}; steps without summary "
              f"{row['mixing_plain_ms']} / {row['stabilizing_plain_ms']}), "
              f"img/s {row['img_s']}, "
              f"peak {row['peak_mib']:.0f} MiB; ms/step {row['ms_per_step_without_metrics']:.2f} "
              f"without the metric passes (median), {row['ms_per_step_with_metrics']:.2f} with "
              f"their host time ({[round(v, 2) for v in metric_s]} s) spread over the "
              f"{len(steps)} steps; metrics {row['metrics']}; input wait "
              f"{row['input_wait_ms']:.3f} ms/step (native prefetcher)", flush=True)
    print(f"trainer: {wall_s:.1f} s wall for phases 5 and 6, launches {counts}", flush=True)
    return report


def run_trainer_thread(data: Path, logdir: Path, native_run: Path):
    """Phase 5 of the same command alone with --no_native_prefetch (the Python prefetch
    thread) and no metric passes: its model_5.npz must equal the native run's bit for
    bit.  Returns its input wait."""
    args = trainer_args(data, logdir, "--no_native_prefetch")
    args[args.index("--ending_phase") + 1] = "5"
    t0 = time.perf_counter()
    cli.main(args)
    wall_s = time.perf_counter() - t0
    events = _events(logdir)
    pipelines = [e["text"] for e in events if e["tag"] == "config/input_pipeline"]
    check(pipelines == ["python_thread"], f"--no_native_prefetch: pipelines {pipelines}")
    with (np.load(native_run / "model_5.npz") as a, np.load(logdir / "model_5.npz") as b):
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        check(sorted(a.files) == sorted(b.files) and not differ,
              f"the Python thread's model_5.npz differs from the native run's in {differ}")
    wait = [e["value"] for e in events if e["tag"] == "Timing/input_wait_ms"][0]
    print(f"trainer phase 5 with the Python prefetch thread: input wait {wait:.3f} ms/step, "
          f"model_5.npz bit-equal to the native run's, {wall_s:.1f} s", flush=True)
    return dict(input_wait_ms=wait, wall_s=wall_s)


def check_bitwise_resume(data: Path, logdir: Path, uninterrupted: Path):
    """The same command in a subprocess with full-state checkpoints, SIGTERM once the
    last phase (6) printed its second step line (exit 75), then again with --auto_resume
    (exit 0): its model_6.npz must equal the uninterrupted run's bit for bit."""
    last = TRAINER_ARGS[TRAINER_ARGS.index("--ending_phase") + 1]
    cmd = [sys.executable, "-u", "-m", "saragan_tpu_torch",
           *trainer_args(data, logdir, "--full_state_checkpoints")]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    lines, phase6, seen = [], False, 0
    try:
        for line in p.stdout:
            lines.append(line)
            phase6 = phase6 or f"Begin mixing epochs in phase {last}" in line
            if phase6 and "\tStep " in line:
                seen += 1
                if seen == 2:
                    p.send_signal(signal.SIGTERM)
                    break
        lines.append(p.stdout.read())
        rc = p.wait(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    out = "".join(lines)
    check(rc == 75 and "INTERRUPTED" in out, f"SIGTERM run exited {rc}:\n{out[-3000:]}")
    pkls = [f for f in os.listdir(logdir) if f.endswith("_interrupt.pkl")]
    check(len(pkls) == 1, f"SIGTERM run left {pkls}")
    again = subprocess.run(cmd + ["--auto_resume"], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=900)
    check(again.returncode == 0 and "auto_resume: continuing from" in again.stdout,
          f"auto_resume run exited {again.returncode}:\n{again.stdout[-3000:]}"
          f"{again.stderr[-3000:]}")
    with (np.load(uninterrupted / f"model_{last}.npz") as a,
          np.load(logdir / f"model_{last}.npz") as b):
        check(sorted(a.files) == sorted(b.files), "the resumed checkpoint has other arrays")
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
    check(not differ, f"resumed model_{last}.npz differs from the uninterrupted run in {differ}")
    seconds = time.perf_counter() - t0
    print(f"bitwise resume: SIGTERM run exited 75 at {pkls[0]}, the auto_resume run exited 0, "
          f"model_{last}.npz bit-equal to the uninterrupted run ({len(a.files)} arrays), "
          f"{seconds:.1f} s", flush=True)
    return dict(interrupt=pkls[0], arrays=len(a.files), seconds=seconds)


def check_conv_v2(items, dtype, detail):
    """Kernel #3 at every (role, x shape, w shape, weight) of `items`: against its plain
    version, against kernel #1, and against itself on a rerun; times weighted by
    `weight` (launches per unit) and summed."""
    g = torch.Generator(device="cuda").manual_seed(5)
    limit = {torch.float32: 1e-4, torch.bfloat16: 1e-2}[dtype]
    route = cf.conv_route(dtype)
    e = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, v1_ms=0.0, bound_ms=0.0, t_bytes=0.0,
             t_ops=0.0, t_flop=0.0, max_abs_err=0.0, max_rel_err=0.0, max_rel_diff_v1=0.0)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for role, xs, ws, weight in items:
            x = torch.randn(xs, generator=g, device="cuda").to(dtype)
            fan_in = ws[0] * ws[1] * ws[2] * ws[3]
            w = (torch.randn(ws, generator=g, device="cuda") * (2.0 / fan_in) ** 0.5).to(dtype)
            routed = cf.launches_by_route(cf.conv3d_flat_v2_cuda)[route]
            y = cf.conv3d_flat_v2_cuda(x, w, role)
            again = cf.conv3d_flat_v2_cuda(x, w, role)
            check(cf.launches_by_route(cf.conv3d_flat_v2_cuda)[route] == routed + 2,
                  f"conv v2 {dtype} x{xs} w{ws}: not through the {route} route")
            y1 = cf.conv3d_flat_cuda(x, w, role)
            ref = cf.conv3d_flat_v2_plain(x, w)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"conv v2 {dtype} x{xs} w{ws}: two runs differ")
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            v1_rel = (y.float() - y1.float()).abs().max().item() / scale
            check(err <= limit * scale and v1_rel <= limit and torch.isfinite(y).all().item(),
                  f"conv v2 {dtype} x{xs} w{ws}: max|err| {err} of {scale}, v1 diff {v1_rel}")
            del ref, y1
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            n, c = xs[:2]
            b_ms, t_bytes, t_ops = _conv_bound(n, c, ws[-1], ws[0] * ws[1] * ws[2],
                                               math.prod(xs[2:]), dtype)
            t = dict(ms=time_ms(lambda: cf.conv3d_flat_v2_cuda(x, w, role), reps=5, warmup=1),
                     v1_ms=time_ms(lambda: cf.conv3d_flat_cuda(x, w, role), reps=5, warmup=1),
                     plain_ms=time_ms(lambda: cf.conv3d_flat_v2_plain(x, w), reps=2, warmup=0),
                     library_ms=time_ms(lambda: F.conv3d(x, wt, padding="same"), reps=5,
                                        warmup=1),
                     bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops,
                     t_flop=2 * n * ws[-1] * c * ws[0] * ws[1] * ws[2] * math.prod(xs[2:]))
            plan = (cf.conv_v2_tc_plan if route == "tc" else cf.conv_v2_simt_plan)(
                xs, ws, sms=cf._sm_count(x.device))
            plan_s = ", ".join(f"{k} {v}" for k, v in vars(plan).items())
            detail.append(dict(kernel="conv3d_flat_v2", route=route, role=role, dtype=str(dtype),
                               x=list(xs), w=list(ws), weight=weight, max_abs_err=err,
                               scale=scale, rel_diff_v1=v1_rel, plan=plan_s,
                               tflops=t["t_flop"] / t["ms"] / 1e9,
                               share_of_bound=b_ms / t["ms"], **t))
            print(f"conv v2 {str(dtype)[6:]} {role} x{xs} w{ws} x{weight:g}: kernel "
                  f"{t['ms']:.4f} ms, kernel #1 {t['v1_ms']:.4f}, plain {t['plain_ms']:.4f}, "
                  f"F.conv3d {t['library_ms']:.4f}, bound {b_ms:.4f} "
                  f"({'ops' if t_ops > t_bytes else 'bytes'}), err {err:.3g} of {scale:.3g}, "
                  f"bit-identical rerun{_rate_line(t)}; plan {plan_s}", flush=True)
            for k in ("ms", "plain_ms", "library_ms", "v1_ms", "bound_ms", "t_bytes", "t_ops",
                      "t_flop"):
                e[k] += weight * t[k]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["max_rel_err"] = max(e["max_rel_err"], err / scale)
            e["max_rel_diff_v1"] = max(e["max_rel_diff_v1"], v1_rel)
    return e


def check_mbstd(detail):
    """Kernel #5 through ``minibatch_stddev_stat_cuda`` at ``profile_mbstd.mbstd_inputs``:
    group 4 at N 8 and 16, the per-sample feature counts of the largest and smallest
    phase-6 D activation, f32 and bf16, and group 3 (not a template size of the kernel)
    at N 12.  Sums over the eight group-4 inputs, as earlier runs summed them."""
    g = torch.Generator(device="cuda").manual_seed(6)
    e = dict(ms=0.0, device_ms=0.0, host_us=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
             t_ops=0.0, max_abs_err=0.0)
    for which, shape, dtype, group in mbstd_inputs():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        before = mb.minibatch_stddev_stat_cuda.launches
        s = mb.minibatch_stddev_stat_cuda(x, group)
        again = mb.minibatch_stddev_stat_cuda(x, group)
        ref = mb.minibatch_stddev_stat_plain(x, group)
        torch.cuda.synchronize()
        label = f"mbstd {dtype} {tuple(x.shape)} G {group}"
        check(mb.minibatch_stddev_stat_cuda.launches == before + 2, f"{label}: launch count")
        check(torch.equal(s, again), f"{label}: reruns differ")
        err = (s - ref).abs().max().item()
        check(err <= 1e-5 * ref.abs().max().item(), f"{label}: max|err| {err}")
        calls = count_kernels(lambda: mb.minibatch_stddev_stat_cuda(x, group))
        check(calls["launch_calls"] == 1, f"{label}: {calls} launches per call")
        nbytes = x.numel() * x.element_size() + s.numel() * 4
        b_ms, t_bytes, t_ops = bound(nbytes, 5 * x.numel(), F32_FLOPS)
        t = time_three_ways(lambda: mb.minibatch_stddev_stat_cuda(x, group))
        t.update(plain_ms=time_ms(lambda: mb.minibatch_stddev_stat_plain(x, group), reps=5,
                                  warmup=1),
                 bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops)
        detail.append(dict(kernel="minibatch_stddev_stat", shape=list(x.shape),
                           dtype=str(dtype), group_size=group, which=which, max_abs_err=err,
                           plan=str(mb.mbstd_plan(shape[0], x[0].numel(), dtype, group,
                                                  cf._sm_count(x.device))),
                           **calls, **t))
        print(f"{label} ({which}): ms {t['ms']:.4f}, device_ms {t['device_ms']:.4f}, host_us "
              f"{t['host_us']:.1f}, plain {t['plain_ms']:.4f}, bound {b_ms:.4f} "
              f"({'bytes' if t_bytes >= t_ops else 'ops'}), err {err:.3g}, bit-identical "
              f"rerun, {calls['launch_calls']} launch call / {calls['kernels']} kernel per call",
              flush=True)
        if group == 4:
            for k in ("ms", "device_ms", "host_us", "plain_ms", "bound_ms", "t_bytes", "t_ops"):
                e[k] += t[k]
        e["max_abs_err"] = max(e["max_abs_err"], err)
    return e


class _TimedExtractor:
    """A feature extractor whose extract() calls are timed (host clock; the call returns
    numpy, so the card's work is inside)."""

    def __init__(self, extractor):
        self.extractor, self.seconds, self.images = extractor, 0.0, 0

    def extract(self, images):
        t0 = time.perf_counter()
        out = self.extractor.extract(images)
        self.seconds += time.perf_counter() - t0
        self.images += len(images)
        return out


def check_metrics(data: Path, params, cfg, tmp: Path):
    """The metrics slice at full width: ``generate()``'s report at phase 6 for 8 volumes
    of 32x128x128 (one batch of 8) from the serving generator on the trainer's npy
    pyramid, every metric on, FID over the random-feature extractor (the
    --allow_uncalibrated_fid route); then FID-only over the Inception network with random
    parameters written to an npz.  Every value finite; FID(real, real) at most 1e-2 of
    FID(real, fake) for both extractors; Inception pool3 features of 8 slices on the card
    within 1e-3 * max|CPU| of the CPU's.  Prints the seconds of feature extraction (on
    the card) against the numpy/scipy metric arithmetic (on the host)."""
    zero_counts()
    model = ckpt.save_params(str(tmp / f"model_{PHASE}"), params, ema=params)
    npz = minc.save_inception_npz(minc.random_inception_params(0), str(tmp / "inception.npz"))
    everything = dict(compute_FID=True, compute_swds=True, compute_ssims=True,
                      compute_psnrs=True, compute_mses=True, compute_nrmses=True)
    out = dict(volumes=BATCH, slices_per_volume=cfg.current_shape(PHASE, 1)[2])
    for name, extra, compute in (
            ("random", dict(allow_uncalibrated_fid=True), everything),
            ("inception", dict(inception_weights=npz), dict(compute_FID=True))):
        rcfg = dataclasses.replace(cfg, **extra)
        extractor = _TimedExtractor(mfid.default_extractor(
            allow_uncalibrated=rcfg.allow_uncalibrated_fid, npz_path=rcfg.inception_weights,
            device="cuda"))
        check(isinstance(extractor.extractor, mfid.RandomConvFeatures if name == "random"
                         else mfid.InceptionFeatures), f"metrics: extractor for {name}")
        t0 = time.perf_counter()
        report = generate("pgan", str(data), model, str(tmp / f"report_{name}"), cfg=rcfg,
                          phase=PHASE, num_samples=BATCH, batch_size=BATCH, seed=0,
                          compute_metrics=compute, device="cuda", extractor=extractor)
        wall = time.perf_counter() - t0
        want = {"fid"} | ({"swd", "psnr", "ssim", "mse", "nrmse"} if compute is everything
                          else set())
        check(set(report) == want and all(math.isfinite(v) for v in report.values()),
              f"metrics ({name}): report {report}")
        # the same real batch (the dataset's seeded stream) against itself
        real = get_numpy_dataset(PHASE, cfg.starting_phase, cfg.start_shape, str(data), None,
                                 seed=0).batch(BATCH).astype(np.float32)
        extracted, sliced, t1 = extractor.seconds, extractor.images, time.perf_counter()
        fid_same = mfid.calculate_fid_given_batch_volumes(real, real, extractor,
                                                          verbose=False)
        frechet_s = time.perf_counter() - t1 - (extractor.seconds - extracted)
        check(abs(fid_same) <= 1e-2 * report["fid"],
              f"metrics ({name}): FID(real, real) {fid_same} against FID(real, fake) "
              f"{report['fid']}")
        row = dict(report=report, fid_real_real=fid_same, wall_s=wall,
                   extraction_s=extracted, slices=sliced,
                   extract_ms_per_volume=1e3 * extracted / (2 * BATCH),
                   host_s=dict(frechet_distance=frechet_s))
        if compute is everything:  # the host's metric arithmetic on the report's arrays
            fake = np.stack([np.load(tmp / f"report_{name}" / f"fake_0000_{j}.npy")[None]
                             for j in range(BATCH)])
            host = row["host_s"]
            for metric, fn in (("swd", lambda: swd.get_swd_for_volumes(real, fake)),
                               ("ssim", lambda: skim.get_ssim(real, fake)),
                               ("psnr", lambda: skim.get_psnr(real, fake)),
                               ("mse", lambda: skim.get_mean_squared_error(real, fake)),
                               ("nrmse", lambda: skim.get_normalized_root_mse(real, fake))):
                t1 = time.perf_counter()
                fn()
                host[metric] = time.perf_counter() - t1
        out[name] = row
        print(f"metrics ({name} features): report {report}; FID(real, real) {fid_same:.4g}; "
              f"generate() {wall:.2f} s, of which extraction {extracted:.2f} s on the card for "
              f"{sliced} slices ({row['extract_ms_per_volume']:.1f} ms per "
              f"{out['slices_per_volume']}-slice volume); host numpy/scipy seconds on the same "
              f"arrays {json.dumps({k: round(v, 3) for k, v in row['host_s'].items()})}",
              flush=True)

    counts = read_counts()
    check(counts["fused"] > 0 and counts["plain"] == 0,
          f"metrics: generate() sampled without the fused kernel or through a plain version "
          f"({counts})")
    out["launches"] = counts

    # the Inception features of 8 slices, card against CPU
    slices = stdnormal_to_8bit_numpy(np.repeat(real[0, 0, :8, :, :, None], 3, axis=-1))
    slices = slices.astype(np.float32)
    p = minc.load_inception_npz(npz)
    on_card = minc.InceptionPool3Features(p, device="cuda").extract(slices)
    on_cpu = minc.InceptionPool3Features(p, device="cpu").extract(slices)
    diff = float(np.abs(on_card - on_cpu).max())
    scale = float(np.abs(on_cpu).max())
    check(diff <= 1e-3 * scale, f"metrics: Inception features card vs CPU {diff} of {scale}")
    out["inception_card_vs_cpu"] = dict(max_abs_diff=diff, scale=scale)
    print(f"metrics: Inception pool3 of 8 slices, card against CPU: max|diff| {diff:.3g} of "
          f"{scale:.3g}", flush=True)
    return out


def _states_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, part)[k], getattr(b, part)[k])
               for part in ("g_params", "d_params", "ema") for k in getattr(a, part)) and all(
        torch.equal(getattr(a, part).mu[k], getattr(b, part).mu[k])
        and torch.equal(getattr(a, part).nu[k], getattr(b, part).nu[k])
        for part in ("g_opt", "d_opt") for k in getattr(a, part).mu)


def big_volume_step():
    """(a) The phase-8 step at batch 2 under the single_chip_big_volume preset (bf16, the
    fused op on, the mixing half): its first step from the seeded init, with pre-drawn
    z and gamma, bit-equal to the same configuration without remat_offload and with
    plain remat; then the main path, the preset's step chained (a warm-up, then
    BIG_STEPS steps with the counts set to 0 just before and read just after): ms per
    step (median, CUDA events), volumes/s, peak MiB and the bytes parked in host memory,
    finite losses, every kernel launched through the tensor-core route and no plain
    version.  Returns (report, launches, per-shape conv and wgrad launches)."""
    arch = get_architecture("pgan")
    cfg = bench_train_config(BIG_PHASE, BIG_BATCH, single_chip_big_volume=True)
    check(cfg.remat_offload and not cfg.batched_passes and not cfg.fused_transitions
          and cfg.current_shape(BIG_PHASE, 1)[2:] == BIG_SPATIAL, f"big volume: preset {cfg}")
    state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=BIG_PHASE,
                                    cfg=cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    real = torch.randn(cfg.current_shape(BIG_PHASE, BIG_BATCH), generator=g, device="cuda")
    draws = losses.draw_inputs(g, BIG_BATCH, cfg.latent_dim, real.shape[1:], torch.bfloat16,
                               "cuda")
    first, report = {}, dict(first_step={})
    for name, c in (("remat_offload", cfg),
                    ("none", dataclasses.replace(cfg, remat_offload=False)),
                    ("remat", dataclasses.replace(cfg, remat_offload=False, remat=True))):
        step = make_train_step(arch, c, BIG_PHASE, *opts, static_alpha=None, conv_engine="flat")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, m = step(state0, real, None, 0.5, 1e-3, 1e-3, draws=draws)
        torch.cuda.synchronize()
        first[name] = (new, m)
        report["first_step"][name] = dict(
            s=time.perf_counter() - t0, peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
            host_mib=step.parked_bytes / 2 ** 20,
            losses=[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)])
        print(f"big volume, first step {name}: {report['first_step'][name]}", flush=True)
    for name in ("none", "remat"):
        check(_states_equal(first["remat_offload"][0], first[name][0])
              and all(torch.equal(a, b) for a, b in zip(first["remat_offload"][1][:5],
                                                        first[name][1][:5])),
              f"big volume: the preset's first step differs from the step under {name}")
    check(report["first_step"]["remat_offload"]["host_mib"] > 0,
          "big volume: remat_offload parked nothing in host memory")
    del first

    step = make_train_step(arch, cfg, BIG_PHASE, *opts, static_alpha=None, conv_engine="flat")
    rng = torch.Generator(device="cuda").manual_seed(6)
    state, _, _ = run_steps(step, state0, real, rng, 0.5, 1)  # warm-up
    zero_counts()  # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    state, ms, metrics = run_steps(step, state, real, rng, 0.5, BIG_STEPS)
    counts = read_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    shapes = (Counter(cf.conv3d_flat_cuda.by_shape), Counter(cf.conv3d_flat_wgrad_cuda.by_shape))
    losses_ = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
    check(all(math.isfinite(v) for row in losses_ for v in row),
          f"big volume: non-finite losses {losses_}")
    check(counts["plain"] == 0, f"big volume: {counts['plain']} plain-version calls on the card")
    for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad"):
        check(counts[k] > 0, f"big volume: kernel {k} not launched ({counts})")
    check(counts["conv_tc"] == counts["forward"] + counts["dgrad"]
          and counts["wgrad_tc"] == counts["wgrad"]
          and counts["conv_simt"] == counts["wgrad_simt"] == 0, f"big volume: routes {counts}")
    for part in ("g_params", "d_params", "ema"):
        check(_moved(getattr(state, part), getattr(state0, part)),
              f"big volume: {part} did not move")
    report.update(step_ms=statistics.median(ms), step_ms_all=ms,
                  vol_s=BIG_BATCH / statistics.median(ms) * 1e3, peak_mib=peak_mib,
                  host_mib=step.parked_bytes / 2 ** 20, losses=losses_, launches=counts)
    print(f"big volume: phase {BIG_PHASE} batch {BIG_BATCH} preset step "
          f"{report['step_ms']:.2f} ms (median of {BIG_STEPS}, CUDA events; all "
          f"{[round(v, 2) for v in ms]}), {report['vol_s']:.3f} vol/s, peak {peak_mib:.0f} MiB, "
          f"{report['host_mib']:.0f} MiB parked in host memory per step, losses {losses_[-1]}, "
          f"launches {counts}", flush=True)
    return report, counts, shapes


def big_volume_kernels(shapes, detail):
    """(b) #1, #1' and #2 at every shape of the big-volume step at 128x512x512, and #4
    forward and backward at the step's two 128x512x512 calls (C = 8), bf16, against
    their plain versions with the tolerances of the phase-6 checks, timed with their
    library calls and bounds; each weighted by its launches per step."""
    conv_shapes, wgrad_shapes = shapes
    conv_shapes = Counter({k: v for k, v in conv_shapes.items() if k[1][2:] == BIG_SPATIAL})
    wgrad_shapes = Counter({k: v for k, v in wgrad_shapes.items() if k[0][2:] == BIG_SPATIAL})
    check(conv_shapes and wgrad_shapes, "big volume: no 128x512x512 conv shapes")
    convs = check_train_convs(conv_shapes, wgrad_shapes, BIG_STEPS, detail,
                              dtypes=(torch.bfloat16,))
    fs = bench_train_config(BIG_PHASE, BIG_BATCH).resolved_filter_spec()[BIG_PHASE - 1]
    fused_fwd, fused_bwd = check_train_fused([(BIG_BATCH, c, *BIG_SPATIAL) for c in fs], detail)
    return convs, fused_fwd, fused_bwd


def write_big_dataset(root: Path):
    """A seeded npy set of 4 volumes of 128x512x512, f32 (537 MB)."""
    rng = np.random.default_rng(0)
    d = root / f"{BIG_SPATIAL[2]}x{BIG_SPATIAL[2]}"
    d.mkdir(parents=True)
    for i in range(4):
        np.save(d / f"{i:03d}.npy", rng.standard_normal(BIG_SPATIAL, dtype=np.float32))


def run_big_trainer(data: Path, logdir: Path):
    """(c) The trainer through ``cli.main`` at phase 8 with --single_chip_big_volume
    --use_pallas_fusion, batch 2, 4 + 4 images: it must return, write model_8.npz with
    finite parameters and a finite summary loss, resolve the flat engine, and run the
    kernels and no plain version (counts set to 0 just before, read just after); the
    EMA sampler then draws one finite 128x512x512 volume from model_8.npz."""
    zero_counts()
    t0 = time.perf_counter()
    cli.main([str(data) if a == "<data>" else a for a in BIG_TRAINER_ARGS]
             + ["--logdir", str(logdir)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["plain"] == 0, f"big trainer: {counts['plain']} plain-version calls")
    for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad"):
        check(counts[k] > 0, f"big trainer: kernel {k} not launched ({counts})")
    model = logdir / f"model_{BIG_PHASE}.npz"
    check(model.is_file(), f"big trainer: {model.name} not written")
    params, ema, _ = ckpt.load_params(str(model), "cpu")
    check(params and all(torch.isfinite(v).all().item() for v in params.values()),
          "big trainer: non-finite parameters in the checkpoint")
    events = _events(logdir)
    engines = [e["text"] for e in events if e["tag"] == "config/conv_engine"]
    check(engines == ["flat"], f"big trainer: engine {engines}")
    d_loss = [e["value"] for e in events if e["tag"] == "Loss/d_loss"]
    check(d_loss and all(math.isfinite(v) for v in d_loss), f"big trainer: Loss/d_loss {d_loss}")
    steps = [e["value"] for e in events if e["tag"].startswith("Timing/step_ms_")]
    peak = [e["value"] for e in events if e["tag"] == "memory/phase_peak_bytes"]
    # the EMA sampler on the written checkpoint: one f32 volume of 128x512x512
    g_params, _ = _load_generator_params(str(model), True, "cuda")
    sampler = make_keyed_sampler(bench_train_config(BIG_PHASE, BIG_BATCH), BIG_PHASE, 1,
                                 device="cuda", conv_engine="flat")
    volume = sampler(g_params, np.array([7]), np.array([0]))
    check(tuple(volume.shape) == (1, 1, *BIG_SPATIAL) and torch.isfinite(volume).all().item(),
          f"big trainer: EMA sample {tuple(volume.shape)} not finite or of the wrong shape")
    report = dict(wall_s=wall_s, launches=counts, d_loss=d_loss, step_ms=steps,
                  peak_mib=peak[0] / 2 ** 20 if peak else None,
                  ema_sample_std=float(volume.float().std()))
    print(f"big trainer: phase {BIG_PHASE} through the CLI in {wall_s:.1f} s, steps (ms) "
          f"{[round(v, 1) for v in steps]}, peak {report['peak_mib']} MiB, d_loss {d_loss}, "
          f"launches {counts}", flush=True)
    return report


def big_volume(detail):
    """The big-volume phases (a), (b), (c); returns (report, the main path's launches,
    the kernel checks' entries)."""
    torch.cuda.empty_cache()
    big, big_launches, big_shapes = big_volume_step()
    kernels = big_volume_kernels(big_shapes, detail)
    big["kernels"] = {"/".join(k): v for k, v in kernels[0].items()}
    big["kernels"].update(fused=kernels[1], fused_grad=kernels[2])
    with tempfile.TemporaryDirectory() as tmp:
        write_big_dataset(Path(tmp) / "data")
        big["trainer"] = run_big_trainer(Path(tmp) / "data", Path(tmp) / "run")
    return big, big_launches, kernels


def big_volume_entries(kernels, launches):
    """The kernels line's rows of the big-volume path: (name, route, source, replaces,
    entry, launches, library key, per, unit)."""
    convs, fused, fused_grad = kernels
    per = (f"one phase-{BIG_PHASE} batch-{BIG_BATCH} bf16 step under single_chip_big_volume "
           f"(sum over its launches at the 128x512x512 shapes); launches counted over "
           f"{BIG_STEPS} steps of the big-volume path, every shape")
    return (
        ("conv3d_flat[forward,bf16,phase8]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
         "saragan_tpu/ops/pallas_conv.py:124", convs[("forward", "bfloat16")],
         launches["forward"], "library_ms", per, BIG_STEPS),
        ("conv3d_flat[dgrad,bf16,phase8]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
         "saragan_tpu/ops/core.py:386", convs[("dgrad", "bfloat16")], launches["dgrad"],
         "library_ms", per, BIG_STEPS),
        ("conv3d_wgrad[bf16,phase8]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad_tc.cu",
         "saragan_tpu/ops/pallas_conv.py:183", convs[("wgrad", "bfloat16")], launches["wgrad"],
         "library_ms", per, BIG_STEPS),
        ("fused_bias_act_pixelnorm[phase8,bf16]", "cuda", FUSED_SOURCE,
         "saragan_tpu/ops/pallas_kernels.py:112", fused, launches["fused"], None, per,
         BIG_STEPS),
        ("fused_bias_act_pixelnorm_grad[phase8,bf16]", "cuda", FUSED_SOURCE,
         "saragan_tpu/ops/pallas_kernels.py:123", fused_grad, launches["fused_grad"], None, per,
         BIG_STEPS))


def _conv_launches():
    """#1 forward, #1' dgrad and #2 launches by route since the counts were set to 0."""
    c = read_counts()
    return {k: c[k] for k in ("forward", "dgrad", "wgrad", "conv_tc", "conv_simt", "wgrad_tc",
                              "wgrad_simt", "plain")}


def family_step():
    """surfgan's flagship step at phase 6, batch 8, bf16, under flat, both halves: the
    main path of this phase (counts set to 0 just before each half's timed steps, read
    just after).  Returns (report, launches over the timed steps, per-shape counts)."""
    cfg = bench_train_config(PHASE, BATCH, architecture=FAMILY)
    arch = get_architecture(FAMILY)
    state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=PHASE,
                                    cfg=cfg, device="cuda")
    real = real_batch(cfg, PHASE, BATCH, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(7)
    state, report, total = state0, {}, Counter()
    conv_shapes, wgrad_shapes = Counter(), Counter()
    for half, static_alpha, alpha in HALVES:
        step = make_train_step(arch, cfg, PHASE, *opts, static_alpha=static_alpha,
                               conv_engine="flat")
        state, _, _ = run_steps(step, state, real, rng, alpha, 1)  # warm-up
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        state, ms, metrics = run_steps(step, state, real, rng, alpha, FAMILY_STEPS)
        counts = _conv_launches()
        conv_shapes.update(cf.conv3d_flat_cuda.by_shape)
        wgrad_shapes.update(cf.conv3d_flat_wgrad_cuda.by_shape)
        total.update(counts)
        losses_ = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
        check(all(math.isfinite(v) for row in losses_ for v in row),
              f"{FAMILY} {half}: non-finite losses {losses_}")
        check(counts["plain"] == 0, f"{FAMILY} {half}: plain versions ran on the card")
        check(min(counts[k] for k in ("forward", "dgrad", "wgrad")) > 0
              and counts["conv_simt"] == counts["wgrad_simt"] == 0
              and counts["conv_tc"] == counts["forward"] + counts["dgrad"],
              f"{FAMILY} {half}: launches {counts}")
        med = statistics.median(ms)
        report[half] = dict(step_ms=med, step_ms_all=ms, vol_s=BATCH / med * 1e3,
                            peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                            launches_per_step={k: counts[k] / FAMILY_STEPS for k in counts},
                            losses=losses_[-1])
        print(f"{FAMILY} step {half}: {med:.2f} ms/step (median of {FAMILY_STEPS}, CUDA events; "
              f"all {[round(v, 2) for v in ms]}), {BATCH / med * 1e3:.2f} vol/s, peak "
              f"{report[half]['peak_mib']:.0f} MiB, launches per step "
              f"{report[half]['launches_per_step']}, losses {losses_[-1]}", flush=True)
    key = "generator/d_z_avg"
    check(not torch.equal(state.g_params[key], state0.g_params[key]),
          f"{FAMILY}: refresh_state did not move {key}")
    for part in ("g_params", "d_params", "ema"):
        check(_moved(getattr(state, part), getattr(state0, part)), f"{FAMILY}: {part} did not move")
    c_in = max(xs[1] for (_, xs, _, _) in conv_shapes)
    check(any(xs[1] % 2 == 1 for (_, xs, _, _) in conv_shapes),
          f"{FAMILY}: no conv with the minibatch-stddev channel (C = F + 1), widest C {c_in}")
    return report, dict(total), (conv_shapes, wgrad_shapes)


def serve_family(model_path, cfg):
    """A few concurrent requests to the service over the family's checkpoint (f32, the
    serving default engine): finite volumes of the phase's shape, each request served
    alone bit-equal to its coalesced response (the per-row noise seeds)."""
    service = GeneratorService.from_checkpoint(FAMILY, model_path, cfg=cfg, phase=PHASE,
                                               batch_size=BATCH, device="cuda")
    srv = make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        service.warmup()
        check(_get(url + "/info")["architecture"] == FAMILY, "info names another family")
        results, errors = {}, []

        def client(num, seed):
            try:
                results[seed] = _post(url + "/generate", {"num_samples": num, "seed": seed})
            except Exception as e:  # noqa: BLE001 (reported by the check below)
                errors.append(f"seed {seed}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=r) for r in FAMILY_REQUESTS]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads), f"requests: {errors}")
        stats = _get(url + "/stats")
        check(stats["max_requests_coalesced"] >= 2, f"{FAMILY} serve: no coalescing: {stats}")
        for num, seed in FAMILY_REQUESTS:
            v = np.load(io.BytesIO(results[seed]))
            check(v.shape == (num, 1, 32, 128, 128) and np.isfinite(v).all(),
                  f"{FAMILY} serve seed {seed}: shape {v.shape}, finite {np.isfinite(v).all()}")
            alone = np.load(io.BytesIO(_post(url + "/generate",
                                             {"num_samples": num, "seed": seed})))
            check(np.array_equal(alone, v), f"{FAMILY} serve seed {seed}: alone differs from "
                                            f"coalesced by {np.abs(alone - v).max()}")
        report = dict(burst_s=burst_s, batches=stats["batches"],
                      max_requests_coalesced=stats["max_requests_coalesced"])
        print(f"{FAMILY} serve: {report}", flush=True)
        return report
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()
        thread.join(timeout=30)


def run_family_trainer(data: Path, logdir: Path):
    """surfgan through ``cli.main`` from phase 5 into phase 6 (counts set to 0 just before,
    read just after): model_5.npz and model_6.npz, finite losses, the flat engine, the
    kernels through the tensor-core route, no plain version, and the w-average moved in
    each phase.  Returns (report, the run's conv and wgrad shapes)."""
    zero_counts()
    t0 = time.perf_counter()
    cli.main([str(data) if a == "<data>" else a for a in FAMILY_TRAINER_ARGS]
             + ["--logdir", str(logdir)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _conv_launches()
    shapes = (Counter(cf.conv3d_flat_cuda.by_shape), Counter(cf.conv3d_flat_wgrad_cuda.by_shape))
    check(counts["plain"] == 0 and min(counts[k] for k in ("forward", "dgrad", "wgrad")) > 0
          and counts["conv_simt"] == counts["wgrad_simt"] == 0,
          f"{FAMILY} trainer: launches {counts}")
    events = _events(logdir)
    check([e["text"] for e in events if e["tag"] == "config/conv_engine"] == ["flat"],
          f"{FAMILY} trainer: engine not flat")
    d_loss = [e["value"] for e in events if e["tag"] == "Loss/d_loss"]
    check(d_loss and all(math.isfinite(v) for v in d_loss), f"{FAMILY} trainer: d_loss {d_loss}")
    avg = {}
    for p in (5, 6):
        params, _, _ = ckpt.load_params(str(logdir / f"model_{p}.npz"), "cpu")
        check(all(torch.isfinite(v).all() for v in params.values()),
              f"{FAMILY} trainer: model_{p}.npz not finite")
        avg[p] = params["generator/d_z_avg"]
    # model_6.npz holds the names and shapes of the family's phase-6 init, which are the
    # JAX package's (tests/test_torch_families.py), so either package reads it
    init6 = get_architecture(FAMILY).init(torch.Generator().manual_seed(0), phase=PHASE,
                                          cfg=bench_train_config(PHASE, BATCH,
                                                                 architecture=FAMILY),
                                          device="meta")
    check({k: tuple(v.shape) for k, v in params.items()}
          == {k: tuple(v.shape) for k, v in init6.items()},
          f"{FAMILY} trainer: model_6.npz names or shapes differ from the phase-6 init")
    check(avg[5].abs().max() > 0 and not torch.equal(avg[5], avg[6]),
          f"{FAMILY} trainer: d_z_avg did not move (|model_5| {avg[5].abs().max()})")
    ms = {p: [e["value"] for e in events if e["tag"].startswith("Timing/step_ms_")
              and (e["step"] < 32) == (p == 5)] for p in (5, 6)}
    report = dict(wall_s=wall_s, launches=counts, d_loss=d_loss, step_ms=ms,
                  d_z_avg_abs_max={p: float(avg[p].abs().max()) for p in avg})
    print(f"{FAMILY} trainer: {wall_s:.1f} s wall for phases 5 and 6, launches {counts}, "
          f"step ms {ms}, |d_z_avg| {report['d_z_avg_abs_max']}", flush=True)
    return report, shapes


def other_families():
    """One flat bf16 step of each other family at phase 4, batch 8, with finite losses;
    the conv launches of each by route.  Returns (report, {family: its conv and wgrad
    shapes})."""
    report, shapes = {}, {}
    for name in OTHER_FAMILIES:
        cfg = bench_train_config(OTHER_PHASE, BATCH, architecture=name)
        arch = get_architecture(name)
        state, opts = init_train_state(arch, torch.Generator().manual_seed(0),
                                       phase=OTHER_PHASE, cfg=cfg, device="cuda")
        real = real_batch(cfg, OTHER_PHASE, BATCH, "cuda")
        step = make_train_step(arch, cfg, OTHER_PHASE, *opts, conv_engine="flat")
        zero_counts()
        rng = torch.Generator(device="cuda").manual_seed(8)
        new, ms, metrics = run_steps(step, state, real, rng, 0.5, 1)
        counts = _conv_launches()
        shapes[name] = (Counter(cf.conv3d_flat_cuda.by_shape),
                        Counter(cf.conv3d_flat_wgrad_cuda.by_shape))
        losses_ = [float(metrics[0].gen_loss), float(metrics[0].disc_loss),
                   float(metrics[0].gp_loss)]
        check(all(math.isfinite(v) for v in losses_), f"{name}: non-finite losses {losses_}")
        check(counts["plain"] == 0 and min(counts[k] for k in ("forward", "dgrad", "wgrad")) > 0
              and counts["conv_simt"] == counts["wgrad_simt"] == 0,
              f"{name}: launches {counts}")
        check(_moved(new.g_params, state.g_params), f"{name}: parameters did not move")
        report[name] = dict(step_ms=ms[0], losses=losses_, launches=counts)
        print(f"{name} step (phase {OTHER_PHASE}, batch {BATCH}, bf16, flat): {ms[0]:.2f} ms "
              f"(first step), losses {losses_}, launches by route {counts}", flush=True)
    return report, shapes


def check_path_convs(label, shapes, checked, detail, dtypes=(torch.float32, torch.bfloat16)):
    """#1, #1' and #2 against their plain versions (`check_train_convs`, in `dtypes`) at
    each conv shape of a path that `checked` (the shapes already held, launch keys without
    their dtype) does not hold yet; adds them to `checked`.  Returns the entries, each shape
    weighted by its launches on the path."""
    conv_shapes, wgrad_shapes = (Counter({k: n for k, n in c.items() if k[:-1] not in done})
                                 for c, done in zip(shapes, checked))
    print(f"kernels at the conv shapes of {label} not checked before: {len(conv_shapes)} of "
          f"{len(shapes[0])} conv, {len(wgrad_shapes)} of {len(shapes[1])} wgrad", flush=True)
    for done, c in zip(checked, (conv_shapes, wgrad_shapes)):
        done.update(k[:-1] for k in c)
    entries = check_train_convs(conv_shapes, wgrad_shapes, 1, detail, dtypes)
    return {"/".join(k): v for k, v in entries.items()}


def families(detail, checked):
    """The families phase: surfgan's flagship step (the main path), its kernels at every
    conv shape of that step in f32 and bf16, the CLI from phase 5 into 6 and serving from
    its checkpoint; one step of each other family; the kernels also at every conv shape
    of the CLI run and of those steps that `checked` (launch keys without their dtype,
    extended here) does not hold yet."""
    torch.cuda.empty_cache()
    step_report, launches, (conv_shapes, wgrad_shapes) = family_step()
    convs = check_train_convs(conv_shapes, wgrad_shapes, 2 * FAMILY_STEPS, detail)
    report = dict(step=step_report, kernels={"/".join(k): v for k, v in convs.items()})
    for done, c in zip(checked, (conv_shapes, wgrad_shapes)):
        done.update(k[:-1] for k in c)
    cfg = bench_train_config(PHASE, BATCH, architecture=FAMILY)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_dataset(tmp / "data")
        report["trainer"], shapes = run_family_trainer(tmp / "data", tmp / "run")
        report["serve"] = serve_family(str(tmp / "run" / f"model_{PHASE}.npz"), cfg)
    # the trainer's phase-5 (batch 16) shapes, then each other family's, held as above
    report["path_kernels"] = {f"{FAMILY} trainer": check_path_convs(
        f"the {FAMILY} trainer (phases 5 and 6)", shapes, checked, detail)}
    report["others"], other_shapes = other_families()
    for name, shapes in other_shapes.items():
        report["path_kernels"][name] = check_path_convs(f"the {name} step", shapes, checked,
                                                        detail)
    return report, launches, convs


def family_entries(convs, launches):
    """The kernels line's rows of surfgan's path."""
    per = (f"one {FAMILY} phase-{PHASE} batch-{BATCH} bf16 step under flat (sum over its "
           f"launches at every conv shape of the step); launches counted over "
           f"{2 * FAMILY_STEPS} steps, both halves")
    return (
        (f"conv3d_flat[forward,bf16,{FAMILY}]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
         "saragan_tpu/ops/pallas_conv.py:124", convs[("forward", "bfloat16")],
         launches["forward"], "library_ms", per, 2 * FAMILY_STEPS),
        (f"conv3d_flat[dgrad,bf16,{FAMILY}]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
         "saragan_tpu/ops/core.py:386", convs[("dgrad", "bfloat16")], launches["dgrad"],
         "library_ms", per, 2 * FAMILY_STEPS),
        (f"conv3d_wgrad[bf16,{FAMILY}]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad_tc.cu",
         "saragan_tpu/ops/pallas_conv.py:183", convs[("wgrad", "bfloat16")], launches["wgrad"],
         "library_ms", per, 2 * FAMILY_STEPS))


# the hpo phase: every optimizer on the flagship step, and the CLI's HPO run modes on the
# flagship configuration at phase 6 (batch 8: --base_batch_size 256), 8 + 8 images a
# trial, the optimizer, its hyperparameters and the learning rates drawn by each trial
HPO_TRIALS = 2  # 3 until the script neared its time limit: a trial costs ~38 s
HPO_ARGS = [
    "pgan", "<data>", "--start_shape", "(1, 1, 4, 4)", "--final_shape", "(1, 128, 512, 512)",
    "--starting_phase", "6", "--ending_phase", "6", "--latent_dim", "256",
    "--network_size", "xs", "--base_batch_size", "256", "--mixing_nimg", "8",
    "--stabilizing_nimg", "8", "--loss_fn", "wgan", "--gp_weight", "10", "--noise_stddev", "0",
    "--compute_dtype", "bfloat16", "--use_pallas_fusion", "--conv_engine", "flat",
    "--optimizer", "None", "--d_use_different_optimizer", "--d_optimizer", "None",
    "--adam_beta1", "None", "--adam_beta2", "None", "--rho", "None", "--momentum", "None",
    "--summary_small_every_nsteps", "8", "--summary_large_every_nsteps", "16",
    "--disable_grad_histograms"]
# scored by FID over random features: one metric pass (training and EMA weights) at the
# first step, and the validation split's at the phase's end
HPO_METRIC_ARGS = ["--calc_metrics", "--compute_FID", "--allow_uncalibrated_fid",
                   "--disable_compute_metrics_test"]
HPO_DRAWN = {"generator_LR", "discriminator_LR", "optimizer", "d_optimizer", "adam_beta1",
             "adam_beta2", "adadelta_rho", "SGD_momentum", "g_lr_sched_inc",
             "g_lr_sched_dec", "d_lr_sched_inc", "d_lr_sched_dec"}
OPTIMIZERS = ("Adam", "SGD", "Momentum", "Adadelta", "RAdam", "LAMB", "LARS", "AdamW")
_TRIAL_LINE = re.compile(r"HPO trial (\d+) starts: device memory allocated (\d+) B "
                         r"\(previous trial's peak (\d+) B\)")
_DONE_LINE = re.compile(r"HPO study done: device memory allocated (\d+) B "
                        r"\(last trial's peak (\d+) B\)")


def _rel_err(a, b):
    """max |a - b| / max |b| over a tensor (0 where both are 0): the card divides by a
    number as a product with its reciprocal, one rounding off the CPU's quotient, which
    an element near 0 would magnify without bound."""
    a, b = a.double().cpu(), b.double().cpu()
    diff = float((a - b).abs().max())
    return diff / float(b.abs().max()) if diff else 0.0


def _update_ms(opts, state, grads, reps=5):
    """The G and D updates of one step, timed (CUDA events, median of `reps` after a
    warm-up)."""
    def once():
        opts[0].update(grads[0], state.g_opt, state.g_params, 1e-3)
        opts[1].update(grads[1], state.d_opt, state.d_params, 1e-3)

    once()
    ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        once()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def optimizers_on_the_step():
    """(a) Each optimizer on the flagship step (phase 6, batch 8, bf16, flat), two mixing
    steps with the previous phase's names frozen: finite losses, the other parameters
    moved, the frozen ones did not, the kernels launched as often as under Adam (tensor
    cores only) and no plain version; then one update of each network on the card against
    the CPU's from the same state and gradients (max|card - CPU| within 1e-6
    of max|CPU| per tensor), and its time."""
    from saragan_tpu_torch.optim.freeze import apply_freeze_names

    arch = get_architecture("pgan")
    base = bench_train_config(PHASE, BATCH)
    real = real_batch(base, PHASE, BATCH, "cuda")
    rows = {}
    for name in OPTIMIZERS:
        cfg = dataclasses.replace(base, optimizer=name, d_optimizer=name)
        state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=PHASE,
                                        cfg=cfg, device="cuda")
        prev = arch.init(torch.Generator().manual_seed(0), phase=PHASE - 1, cfg=cfg,
                         device="meta")
        frozen = apply_freeze_names({**state0.g_params, **state0.d_params}, prev)
        step = make_train_step(arch, cfg, PHASE, *opts, frozen_names=frozen, freeze=True,
                               static_alpha=None, conv_engine="flat")
        rng = torch.Generator(device="cuda").manual_seed(1)
        zero_counts()
        state, step_ms, metrics = run_steps(step, state0, real, rng, 0.5, 2)
        counts = read_counts()
        losses = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
        check(all(math.isfinite(v) for row in losses for v in row),
              f"hpo[{name}]: non-finite losses {losses}")
        check(counts["plain"] == 0, f"hpo[{name}]: {counts['plain']} plain-version calls")
        check(counts["conv_simt"] == counts["wgrad_simt"] == 0
              and min(counts[k] for k in ("forward", "dgrad", "wgrad", "fused",
                                          "fused_grad")) > 0,
              f"hpo[{name}]: launches {counts}")
        old, new = {**state0.g_params, **state0.d_params}, {**state.g_params, **state.d_params}
        check(frozen and all(torch.equal(old[k], new[k]) for k in frozen),
              f"hpo[{name}]: a frozen name moved under mixing")
        moved = sum(not torch.equal(old[k], new[k]) for k in old if k not in frozen)
        check(moved > 0 and _moved(state.g_params, state0.g_params)
              and _moved(state.d_params, state0.d_params), f"hpo[{name}]: nothing moved")
        # one update on the card and on the CPU from the same state and gradients
        gen = torch.Generator(device="cuda").manual_seed(2)
        grads = tuple({k: torch.randn(v.shape, generator=gen, device="cuda") * 1e-2
                       for k, v in params.items()} for params in (state.g_params,
                                                                   state.d_params))
        err = 0.0
        for opt, params, opt_state, g in ((opts[0], state.g_params, state.g_opt, grads[0]),
                                          (opts[1], state.d_params, state.d_opt, grads[1])):
            p_gpu, s_gpu = opt.update(g, opt_state, params, 1e-3)
            cpu = {k: v.cpu() for k, v in params.items()}
            cpu_state = opt_state._replace(slots={s: {k: v.cpu() for k, v in d.items()}
                                                  for s, d in opt_state.slots.items()})
            p_cpu, s_cpu = opt.update({k: v.cpu() for k, v in g.items()}, cpu_state, cpu,
                                      1e-3)
            pairs = [(p_gpu[k], p_cpu[k]) for k in cpu]
            pairs += [(s_gpu.slots[s][k], s_cpu.slots[s][k]) for s in s_cpu.slots for k in cpu]
            err = max([err] + [_rel_err(a, b) for a, b in pairs])
        check(err <= 1e-6, f"hpo[{name}]: the card's update differs from the CPU's by {err}")
        rows[name] = dict(
            update_ms=_update_ms(opts, state, grads), step_ms=step_ms, losses=losses[-1],
            frozen=len(frozen), moved=moved, max_rel_err_vs_cpu=err,
            launches={k: counts[k] for k in ("forward", "dgrad", "wgrad", "fused",
                                             "fused_grad")},
            slots=list(opts[0].slot_names))
        del state0, state, step, grads
    adam = rows["Adam"]
    for name, r in rows.items():
        check(r["launches"] == adam["launches"],
              f"hpo[{name}]: launches {r['launches']}, under Adam {adam['launches']}")
        print(f"hpo[{name}]: update of G and D {r['update_ms']:.3f} ms/step (Adam "
              f"{adam['update_ms']:.3f}; CUDA events, median of 5), steps "
              f"{[round(v, 2) for v in r['step_ms']]} ms, card vs CPU {r['max_rel_err_vs_cpu']:.2e} "
              f"relative, {r['frozen']} frozen names kept, {r['moved']} others moved, "
              f"launches {r['launches']}", flush=True)
    return rows


class _Tee(io.TextIOBase):
    """sys.stdout that also keeps the lines matching `pattern` with their time."""

    def __init__(self, out, pattern):
        self.out, self.pattern, self.hits, self._buf = out, pattern, [], ""

    def write(self, text):
        self._buf += text
        *lines, self._buf = self._buf.split("\n")
        for line in lines:
            if self.pattern.search(line):
                self.hits.append((time.perf_counter(), line))
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _hpo_args(data: Path, logdir: Path, db: Path, study: str, *extra):
    return [str(data) if a == "<data>" else a for a in HPO_ARGS] + [
        "--logdir", str(logdir), "--optuna_storage", f"sqlite:///{db}",
        "--optuna_study_name", study, *extra]


def cli_study(data: Path, tmp: Path):
    """(b) A study through the CLI (``cli.main`` in process, the counts set to 0 just
    before and read just after): every trial COMPLETE with a finite value, its params
    covering the drawn names, the kernels launched and no plain version, the device
    memory at each trial's start and at the end the same."""
    from saragan_tpu_torch.hpo import load_study

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tee = _Tee(sys.stdout, re.compile(f"{_TRIAL_LINE.pattern}|{_DONE_LINE.pattern}"))
    sys.stdout = tee
    try:
        with narrow_fid_features():
            cli.main(_hpo_args(data, tmp / "study", tmp / "s.db", "smoke", *HPO_METRIC_ARGS,
                               "--optuna_ntrials", str(HPO_TRIALS), "--optuna_sampler", "TPE"))
    finally:
        sys.stdout = tee.out
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["plain"] == 0, f"hpo study: {counts['plain']} plain-version calls")
    check(min(counts[k] for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad")) > 0
          and counts["conv_simt"] == counts["wgrad_simt"] == 0, f"hpo study: {counts}")
    trials = load_study("smoke", f"sqlite:///{tmp / 's.db'}").trials
    check([t.state for t in trials] == ["COMPLETE"] * HPO_TRIALS
          and all(t.value is not None and math.isfinite(t.value) for t in trials),
          f"hpo study: {[(t.state, t.value) for t in trials]}")
    check(all(HPO_DRAWN <= set(t.params) for t in trials),
          f"hpo study: params {[sorted(t.params) for t in trials]}")
    starts = [_TRIAL_LINE.search(line) for _, line in tee.hits if _TRIAL_LINE.search(line)]
    done = [_DONE_LINE.search(line) for _, line in tee.hits if _DONE_LINE.search(line)]
    check([int(m.group(1)) for m in starts] == list(range(HPO_TRIALS)) and len(done) == 1,
          f"hpo study: memory lines {tee.hits}")
    levels = [int(m.group(2)) for m in starts] + [int(done[0].group(1))]
    check(len(set(levels)) == 1,
          f"hpo study: device memory allocated at the trials' starts and the end {levels}")
    peaks = [int(m.group(3)) for m in starts[1:]] + [int(done[0].group(2))]
    times = [t for t, _ in tee.hits]
    trial_s = [b - a for a, b in zip(times, times[1:])]
    report = dict(wall_s=wall_s, trial_s=trial_s, peak_mib=[p / 2 ** 20 for p in peaks],
                  allocated_bytes=levels, launches=counts,
                  trials=[dict(number=t.number, value=t.value, params=t.params)
                          for t in trials])
    print(f"hpo study: {HPO_TRIALS} trials COMPLETE, values "
          f"{[round(t.value, 4) for t in trials]}, optimizers "
          f"{[(t.params['optimizer'], t.params['d_optimizer']) for t in trials]}; "
          f"{[round(v, 1) for v in trial_s]} s per trial, peak "
          f"{[round(p / 2 ** 20) for p in peaks]} MiB per trial, device memory allocated "
          f"{levels[0]} B at every trial's start and after the study; {wall_s:.1f} s; "
          f"launches {counts}", flush=True)
    return report


def _cli_process(args, env=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **(env or {}))
    return subprocess.Popen([sys.executable, "-u", "-m", "saragan_tpu_torch", *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs, timeout=600):
    """{name: (exit code, output)} of the subprocesses, each killed if it outlives the
    limit."""
    out = {}
    try:
        for name, p in procs.items():
            text, _ = p.communicate(timeout=timeout)
            out[name] = (p.returncode, text)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def replay_and_workers(data: Path, tmp: Path, study_report):
    """(c) best-trial replay of the study's database and (d) two inter-trial workers on
    a new study (no metric pass in any of them: the workers' values are None), all three
    processes at once on the one card."""
    from saragan_tpu_torch.hpo import load_study

    t0 = time.perf_counter()
    # the replay trains the best trial's params without the metric passes: its value is
    # not stored, and the passes' host time is most of a trial
    procs = {"replay": _cli_process(_hpo_args(data, tmp / "replay", tmp / "s.db", "smoke",
                                              "--optuna_use_best_trial"))}
    for wid in (0, 1):
        procs[f"worker{wid}"] = _cli_process(
            _hpo_args(data, tmp / "inter", tmp / "inter.db", "inter", "--optuna_distributed",
                      "--optuna_ntrials", "2", "--optuna_sampler", "random"),
            env={"SARAGAN_WORKER_ID": str(wid), "SARAGAN_NUM_WORKERS": "2"})
    done = _finish(procs)
    wall_s = time.perf_counter() - t0
    for name, (rc, text) in done.items():
        check(rc == 0, f"hpo {name} exited {rc}:\n{text[-3000:]}")
    best = min((t for t in study_report["trials"]), key=lambda t: t["value"])
    replay = re.search(r"Replaying best trial (\d+) with params (.*)", done["replay"][1])
    check(replay and int(replay.group(1)) == best["number"]
          and replay.group(2).strip() == str(best["params"]),
          f"hpo replay: {replay and replay.group(0)} against the best trial {best}")
    check((tmp / "replay" / f"model_{PHASE}.npz").is_file(), "hpo replay: no checkpoint")
    trials = load_study("inter", f"sqlite:///{tmp / 'inter.db'}").trials
    ran = {name: [int(m) for m in re.findall(r"HPO trial (\d+) starts", done[name][1])]
           for name in ("worker0", "worker1")}
    check([t.state for t in trials] == ["COMPLETE", "COMPLETE"]
          and sorted(ran["worker0"] + ran["worker1"]) == [0, 1]
          and all(len(v) == 1 for v in ran.values())
          and all((tmp / "inter" / str(w) / f"model_{PHASE}.npz").is_file() for w in (0, 1)),
          f"hpo inter-trial: {[t.state for t in trials]}, trials by worker {ran}")
    print(f"hpo replay: best trial {best['number']} replayed, exit 0; inter-trial: 2 workers "
          f"on one study, trials by worker {ran}, both COMPLETE, exit 0; {wall_s:.1f} s for "
          f"the three processes", flush=True)
    return dict(replayed=best["number"], workers=ran, wall_s=wall_s)


def generate_config_args(tmp: Path):
    """(e) The generate CLI with --config_args on a surfgan checkpoint written with a
    --first_conv_nfilters (64) other than the table's: two finite volumes at phase 6."""
    from saragan_tpu_torch.tools import generate as gen_tool

    cfg = bench_train_config(PHASE, BATCH, architecture=FAMILY, first_conv_nfilters=64)
    params = get_architecture(FAMILY).init(torch.Generator().manual_seed(0), phase=PHASE,
                                           cfg=cfg, device="cuda")
    model = ckpt.save_params(str(tmp / "surfgan64" / f"model_{PHASE}"), params, ema=params)
    out = tmp / "generated"
    t0 = time.perf_counter()
    gen_tool.main([FAMILY, str(tmp / "data"), model, str(out), "--phase", str(PHASE),
                   "--minimal", "--num_samples", "2", "--config_args",
                   "--first_conv_nfilters", "64"])
    seconds = time.perf_counter() - t0
    vols = [np.load(out / f"fake_{i:04d}.npy") for i in range(2)]
    shape = tuple(cfg.current_shape(PHASE, 1)[2:])
    check(all(v.shape == shape and np.isfinite(v).all() for v in vols),
          f"generate --config_args: {[v.shape for v in vols]}")
    print(f"generate --config_args --first_conv_nfilters 64: 2 finite volumes of {shape} "
          f"from a {FAMILY} checkpoint with a 64-filter first layer, {seconds:.1f} s",
          flush=True)
    return dict(seconds=seconds, shape=shape)


def hpo():
    """The hpo phase: (a) every optimizer on the flagship step, (b) a 2-trial CLI study,
    (c) best-trial replay, (d) two inter-trial workers, (e) generate --config_args."""
    torch.cuda.empty_cache()
    report = dict(optimizers=optimizers_on_the_step())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_dataset(tmp / "data")
        report["study"] = cli_study(tmp / "data", tmp)
        report["replay_and_workers"] = replay_and_workers(tmp / "data", tmp, report["study"])
        report["generate"] = generate_config_args(tmp)
    return report


# the tools phase: the rest of tools/ at the flagship's width (bench.py:99-119's model at
# phase 6): test_network for every family (f32, as its CLI builds it, batch 8), the
# phase-6 pgan generator exported and served from the artifact, its checkpoint through a
# TF bundle and back, and a synthetic LIDC-like CT series through the DICOM reader and
# the data preparation on the card
TOOLS_FAMILIES = ("pgan", "pgan2", "pgandeep", "stylegan", "stylegan2", "surfgan")
TOOLS_NET_ARGS = ["--phase", str(PHASE), "--start_shape", "(1, 1, 4, 4)", "--final_shape",
                  "(1, 128, 512, 512)", "--latent_dim", "256", "--network_size", "xs",
                  "--batch_size", str(BATCH)]
CT_SLICES, CT_SPACING = 160, (2.5, 0.703125, 0.703125)  # (z, y, x) mm, LIDC-IDRI's
# card against CPU, per pyramid level in HU/1024 units: two float32 ulps at the top of the
# normalized range [-1, 2] (2^-21): the resample's float64 sums may round to float32 one
# ulp apart on the two devices, which the Lanczos filter (sum of |weights| < 2) carries
# into each level, plus the level's own rounding
PYRAMID_CARD_ATOL = 2.0 ** -21


def tools_test_network(checked, detail):
    """``tools.test_network``'s CLI for every family at phase 6 (batch 8, f32, the engine
    resolved for the card: flat), counts set to 0 before each: the report finite, #1, #1'
    and #2 launched through the CUDA-core route and no plain version; then the kernels
    against their plain versions (f32) at every conv shape of those steps not checked
    before.  Returns (report, path kernel entries)."""
    from saragan_tpu_torch.tools import test_network

    report, shapes = {}, (Counter(), Counter())
    for name in TOOLS_FAMILIES:
        torch.cuda.empty_cache()
        zero_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            r = test_network.main([name] + TOOLS_NET_ARGS)
        counts = _conv_launches()
        shapes[0].update(cf.conv3d_flat_cuda.by_shape)
        shapes[1].update(cf.conv3d_flat_wgrad_cuda.by_shape)
        lines = out.getvalue().splitlines()
        check(r["conv_engine"] == "flat" and r["device"].startswith("cuda"),
              f"test_network {name}: {r['conv_engine']} on {r['device']}")
        check(math.isfinite(r["gen_loss"]) and math.isfinite(r["disc_loss"]),
              f"test_network {name}: losses {r['gen_loss']}, {r['disc_loss']}")
        check(r["generator_output_shape"] == (BATCH, 1, 32, 128, 128),
              f"test_network {name}: G output {r['generator_output_shape']}")
        check(counts["plain"] == 0 and min(counts[k] for k in ("forward", "dgrad", "wgrad")) > 0
              and counts["conv_tc"] == counts["wgrad_tc"] == 0,
              f"test_network {name}: launches {counts}")
        report[name] = dict(r, launches=counts, listing_lines=len(lines) - 4)
        print(f"test_network {name}: " + json.dumps(report[name], default=str), flush=True)
    kernels = check_path_convs("test_network (six families, phase 6, batch 8, f32)", shapes,
                               checked, detail, dtypes=(torch.float32,))
    return report, kernels


def _serving_forward(cfg, params, engine):
    """The checkpoint path's forward on a given z (``tools/generate.py``'s serving
    configuration: fused transitions, the fused op, f32, deterministic cuDNN)."""
    scfg = dataclasses.replace(cfg, fused_transitions=True, use_pallas_fusion=True)
    arch = get_architecture("pgan")

    def forward(z):
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            return arch.generator(params, z, 0.0, phase=PHASE, cfg=scfg, conv_engine=engine,
                                  train=False)

    return forward


_LOAD_ALONE = r"""
import sys
import numpy as np
import torch
program = torch.export.load(sys.argv[1])
z = torch.from_numpy(np.load(sys.argv[2])).cuda()
with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                 deterministic=True, allow_tf32=False):
    out = program.module()(z)
want = np.load(sys.argv[3])
assert np.array_equal(out.cpu().numpy(), want), float(np.abs(out.cpu().numpy() - want).max())
assert not [m for m in sys.modules if m.split(".")[0] in ("saragan_tpu_torch", "saragan_tpu")]
print("loaded without the package, bit-equal")
"""


def tools_artifact(model_path: Path, cfg, tmp: Path):
    """``export_model``'s CLI on the phase-6 pgan checkpoint, then the artifact served over
    HTTP: 4 concurrent requests (counts set to 0 just before: the artifact launches no
    hand-written kernel, by the reference's design), each request alone bit-equal to its
    coalesced response; the artifact bit-equal to the live generator under `direct`
    (fused transitions, no fused op) on the same z and within 1e-4 * max|ref| of the
    checkpoint path under `flat` with the fused op; the ms per forward of the three
    routes; the artifact loaded in a process that never imports the package."""
    from saragan_tpu_torch.tools import export_model

    art = tmp / "g.pt2"
    t0 = time.perf_counter()
    export_model.main(["pgan", "--model_path", str(model_path), "--out", str(art), "--phase",
                       str(PHASE), "--batch_size", str(BATCH), "--latent_dim", "256",
                       "--start_shape", "(1, 1, 4, 4)", "--final_shape", "(1, 128, 512, 512)",
                       "--network_size", "xs"])
    export_s = time.perf_counter() - t0
    service = GeneratorService.from_artifact(str(art), latent_dim=256)
    srv = make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        service.warmup()
        info = _get(url + "/info")
        check(info["source"] == "torch_export_artifact" and info["batch_size"] == BATCH
              and info["device"].startswith("cuda"), f"artifact info {info}")
        zero_counts()
        results, errors = {}, []

        def client(num, seed):
            try:
                results[seed] = _post(url + "/generate", {"num_samples": num, "seed": seed})
            except Exception as e:  # noqa: BLE001 (reported by the check below)
                errors.append(f"seed {seed}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=r) for r in REQUESTS]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads), f"requests: {errors}")
        launches = read_counts()
        stats = _get(url + "/stats")
        check(stats["max_requests_coalesced"] >= 2, f"artifact: no coalescing: {stats}")
        check(sum(v for k, v in launches.items()) == 0,
              f"artifact: a hand-written kernel or plain version ran: {launches}")
        for num, seed in REQUESTS:
            v = np.load(io.BytesIO(results[seed]))
            check(v.shape == (num, 1, 32, 128, 128) and np.isfinite(v).all(),
                  f"artifact seed {seed}: shape {v.shape}, finite {np.isfinite(v).all()}")
            alone = np.load(io.BytesIO(_post(url + "/generate", {"num_samples": num, "seed": seed})))
            check(np.array_equal(alone, v), f"artifact seed {seed}: alone differs from coalesced "
                                            f"by {np.abs(alone - v).max()}")
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()
        thread.join(timeout=30)

    gen = export_model.load_exported(str(art))
    g_params, _ = _load_generator_params(str(model_path), True, "cuda")
    z = torch.from_numpy(np.random.default_rng(21).normal(size=(BATCH, 256)).astype(np.float32)
                         ).cuda()
    out = gen(z)
    export_cfg = dataclasses.replace(cfg, fused_transitions=True, use_pallas_fusion=False)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                     deterministic=True, allow_tf32=False):
        live_out = get_architecture("pgan").generator(g_params, z, 0.0, phase=PHASE,
                                                      cfg=export_cfg, conv_engine="direct",
                                                      train=False)
    flat = _serving_forward(cfg, g_params, "flat")
    direct = _serving_forward(cfg, g_params, "direct")
    flat_out = flat(z)
    live_diff = (out - live_out).abs().max().item()
    flat_diff = (out - flat_out).abs().max().item()
    scale = flat_out.abs().max().item()
    check(torch.equal(out, live_out), f"artifact vs live generator (direct): {live_diff}")
    check(flat_diff <= 1e-4 * scale, f"artifact vs checkpoint path (flat + #4): {flat_diff} "
                                     f"> 1e-4 * {scale}")
    ms = dict(artifact=time_ms(lambda: gen(z)), checkpoint_direct=time_ms(lambda: direct(z)),
              checkpoint_flat=time_ms(lambda: flat(z)))
    np.save(tmp / "z.npy", z.cpu().numpy())
    np.save(tmp / "out.npy", out.cpu().numpy())
    alone = subprocess.run([sys.executable, "-c", _LOAD_ALONE, str(art), str(tmp / "z.npy"),
                            str(tmp / "out.npy")], cwd=str(tmp), capture_output=True, text=True,
                           timeout=300)
    check(alone.returncode == 0, f"artifact in a process without the package: {alone.stderr}")
    report = dict(mb=art.stat().st_size / 1e6, export_s=export_s, burst_s=burst_s,
                  dispatches=stats["batches"], max_requests_coalesced=stats["max_requests_coalesced"],
                  launches=launches, live_max_abs_diff=live_diff, flat_max_abs_diff=flat_diff,
                  flat_scale=scale, forward_ms=ms, alone=alone.stdout.strip())
    print(f"artifact: {report['mb']:.2f} MB, exported in {export_s:.2f} s; 4 concurrent requests "
          f"in {burst_s:.3f} s ({stats['batches']} dispatches); bit-equal to the live generator; "
          f"vs flat + #4 max|diff| {flat_diff:.3g} of {scale:.3g}; ms per batch-8 forward "
          f"(CUDA events, median of 20): {json.dumps(ms)}; subprocess: {report['alone']}",
          flush=True)
    return report


def tools_tf_checkpoint(model_path: Path, cfg, tmp: Path):
    """The checkpoint (params + EMA) through ``tf_checkpoint``'s CLI: export, show, import;
    every array bit-equal, the service over the imported npz bit-equal to the service over
    the original; seconds per pass, the CRC-32C route and its MB/s."""
    from saragan_tpu_torch.tools import tf_checkpoint as tfc

    prefix, back = tmp / "tf" / f"model_{PHASE}", tmp / "back" / f"model_{PHASE}.npz"
    seconds = {}
    for cmd, argv in (("export", [str(model_path), str(prefix)]), ("show", [str(prefix)]),
                      ("import", [str(prefix), str(back)])):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            check(tfc.main([cmd] + argv) == 0, f"tf_checkpoint {cmd}")
        seconds[cmd] = time.perf_counter() - t0
    p0, e0, _ = ckpt.load_params(str(model_path), "cpu")
    p1, e1, meta = ckpt.load_params(str(back), "cpu")
    check(meta.get("imported_from_tf") == 1.0 and set(p0) == set(p1) and set(e0) == set(e1),
          "tf_checkpoint: names differ after the round trip")
    check(all(torch.equal(p0[k], p1[k]) for k in p0) and all(torch.equal(e0[k], e1[k]) for k in e0),
          "tf_checkpoint: an array changed in the round trip")
    shard = (tmp / "tf" / f"model_{PHASE}.data-00000-of-00001").read_bytes()
    t0 = time.perf_counter()
    tfc.crc32c(shard)
    crc_s = time.perf_counter() - t0
    vols = []
    for path in (model_path, back):
        service = GeneratorService.from_checkpoint("pgan", str(path), cfg=cfg, phase=PHASE,
                                                   batch_size=BATCH, device="cuda")
        try:
            vols.append(service.generate(BATCH, seed=5))
        finally:
            service.close()
    check(np.array_equal(*vols), "tf_checkpoint: the imported checkpoint serves other volumes")
    report = dict(seconds=seconds, crc32c_route=tfc.CRC32C_ROUTE, data_mb=len(shard) / 1e6,
                  crc32c_mb_s=len(shard) / 1e6 / crc_s, tensors=len(p0) + len(e0))
    print(f"tf_checkpoint: {report['tensors']} tensors, data shard {report['data_mb']:.1f} MB; "
          f"s per pass {json.dumps(seconds)}; CRC-32C route {tfc.CRC32C_ROUTE}, "
          f"{report['crc32c_mb_s']:.1f} MB/s; round trip bit-equal, served volumes bit-equal",
          flush=True)
    return report


def write_ct_series(root: Path):
    """A synthetic LIDC-like CT series: 160 slices of 512x512 int16 (slope 1, intercept
    -1024), spacing 2.5 x 0.703125 x 0.703125 mm, a body with lungs and a spine in air,
    made from a seed."""
    from saragan_tpu_torch.tools import dicom

    root.mkdir(parents=True)
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[:512, :512]
    body = ((yy - 256) / 200) ** 2 + ((xx - 256) / 230) ** 2 <= 1
    lungs = ((((yy - 240) / 90) ** 2 + ((xx - 170) / 60) ** 2 <= 1)
             | (((yy - 240) / 90) ** 2 + ((xx - 342) / 60) ** 2 <= 1))
    spine = ((yy - 380) / 30) ** 2 + ((xx - 256) / 30) ** 2 <= 1
    base = np.where(body, 40.0, -1000.0)
    base[lungs] = -850.0
    base[spine] = 700.0
    for i in range(CT_SLICES):
        hu = base + rng.normal(0.0, 20.0, base.shape)
        stored = np.clip(np.round(hu + 1024.0), 0, 4095).astype(np.int16)
        dicom.write_ct_slice(str(root / f"{i:04d}.dcm"), stored, instance_number=i + 1,
                             z_position=CT_SPACING[0] * i, pixel_spacing=CT_SPACING[1:],
                             slice_thickness=CT_SPACING[0], rescale_slope=1.0,
                             rescale_intercept=-1024.0)


def tools_prepare_data(tmp: Path):
    """The series through ``create_dataset`` on the card (8 levels, 128x512x512 down to
    1x4x4), every level within PYRAMID_CARD_ATOL of the same stages on the CPU; seconds of
    the device stages per volume, card and CPU; the 128x128 level read back with
    ``get_numpy_dataset`` at phase 6."""
    from saragan_tpu_torch.tools import dicom, prepare_data

    series = tmp / "ct" / "case0000"
    t0 = time.perf_counter()
    write_ct_series(series)
    write_s = time.perf_counter() - t0
    mb_in = sum(f.stat().st_size for f in series.iterdir()) / 1e6
    t0 = time.perf_counter()
    check(prepare_data.create_dataset([str(series)], str(tmp / "data")) == [0],
          "create_dataset")
    dataset_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    array, spacing = dicom.read_series(str(series))
    read_s = time.perf_counter() - t0
    check(array.shape == (CT_SLICES, 512, 512) and spacing == CT_SPACING,
          f"series read as {array.shape}, spacing {spacing}")
    seconds = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        levels = prepare_data.process_volume(array, spacing, device=dev)
        torch.cuda.synchronize()
        seconds[dev] = time.perf_counter() - t0
    diffs = {}
    for level in levels:
        size = level.shape[-1]
        got = np.load(tmp / "data" / f"{size}x{size}" / "0000.npy")
        want = level.to(torch.float32).numpy()
        check(got.shape == want.shape and np.isfinite(got).all(), f"level {size}: {got.shape}")
        diffs[f"{size}x{size}"] = float(np.abs(got.astype(np.float64) - want).max())
        check(diffs[f"{size}x{size}"] <= PYRAMID_CARD_ATOL,
              f"level {size}x{size}: card vs CPU {diffs[f'{size}x{size}']} > {PYRAMID_CARD_ATOL}")
    check(sorted(diffs, key=lambda k: int(k.split("x")[0])) == [
        f"{s}x{s}" for s in (4, 8, 16, 32, 64, 128, 256, 512)], f"levels {sorted(diffs)}")
    ds = get_numpy_dataset(PHASE, PHASE, "(1, 1, 4, 4)", str(tmp / "data"), None)
    batch = ds.batch(1)
    check(batch.shape[-3:] == (32, 128, 128) and np.isfinite(batch).all(),
          f"get_numpy_dataset at phase {PHASE}: {batch.shape}")
    report = dict(input_mb=mb_in, write_series_s=write_s, read_series_s=read_s,
                  create_dataset_s=dataset_s, stages_s=seconds, card_vs_cpu_max_abs=diffs,
                  phase6_batch_shape=list(batch.shape))
    print(f"prepare_data: {CT_SLICES} slices of 512x512 ({mb_in:.1f} MB) -> 8 levels; "
          f"create_dataset on the card {dataset_s:.2f} s (read {read_s:.2f} s); device stages "
          f"per volume: card {seconds['cuda']:.3f} s, CPU {seconds['cpu']:.3f} s; card vs CPU "
          f"max|diff| {max(diffs.values()):.3g} (limit {PYRAMID_CARD_ATOL:.3g}); phase-6 batch "
          f"{list(batch.shape)}", flush=True)
    return report


def tools(detail, checked, model_path: Path, cfg):
    """The tools phase: test_network for every family, export -> serve --artifact, the TF
    bundle round trip, DICOM -> pyramid on the card."""
    report = {}
    report["test_network"], report["test_network_kernels"] = tools_test_network(checked, detail)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        report["artifact"] = tools_artifact(model_path, cfg, tmp)
        report["tf_checkpoint"] = tools_tf_checkpoint(model_path, cfg, tmp)
        report["prepare_data"] = tools_prepare_data(tmp)
    return report


# ---------------------------------------------------------------------------
# Phase 16: the 2-D path
# ---------------------------------------------------------------------------


def write_jpegs(root: Path):
    """A seeded JPEG class folder: one class, 64 train and 16 test images of 256^2 RGB
    (smooth fields plus noise, quality 90), written with PIL."""
    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 256), np.linspace(-1, 1, 256), indexing="ij")
    for split, n in (("train", 64), ("test", 16)):
        d = root / split / "n00000001"
        d.mkdir(parents=True)
        for i in range(n):
            f = rng.uniform(1, 6, size=(3, 2))
            base = np.stack([np.sin(f[c, 0] * yy) * np.cos(f[c, 1] * xx) for c in range(3)], -1)
            img = np.clip(127.5 * (1 + base) + rng.normal(0, 12, size=base.shape), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(d / f"img_{i:03d}.JPEG", quality=90)


def check_decoder(root: Path):
    """The JPEG decoder this machine has, printed, and held: libjpeg's batch decode within
    1.5/127.5 of PIL and its resize bit-equal to the plain PyTorch resize; PIL's
    antialiased resize within 1.5/127.5 of the plain resize of PIL's own pixels.  The
    first 16 train images at 128^2 (phase 6)."""
    from PIL import Image

    decoder = jpeg_decoder()
    name = decoder_name(decoder)
    print(f"JPEG decoder: {name} (jpeglib.h {'found' if _build.JPEG_HEADER.is_file() else 'absent'})",
          flush=True)
    check(native.have_jpeg() == _build.JPEG_HEADER.is_file(),
          "the host library's libjpeg decoder does not follow jpeglib.h")
    files = sorted(str(p) for p in (root / "train").rglob("*.JPEG"))[:16]
    size = 128
    t0 = time.perf_counter()
    if decoder == "libjpeg":
        imgs = native.decode_jpeg_batch(files, size, 3)
    else:
        imgs = np.stack([imagenet._decode_resize(f, size, 3) for f in files])
    decode_s = time.perf_counter() - t0
    plain_err = 0.0
    for f, img in zip(files, imgs):
        with Image.open(f) as im:
            pixels = torch.from_numpy(np.array(im.convert("RGB")))
        plain = native.resize_triangle_plain(pixels, size).numpy()
        plain_err = max(plain_err, float(np.abs(plain - img).max()))
    if decoder == "libjpeg":
        pil = np.stack([imagenet._decode_resize(f, size, 3) for f in files])
        check(plain_err == 0.0, f"libjpeg resize differs from the plain resize by {plain_err}")
        pil_err = float(np.abs(pil - imgs).max())
        check(pil_err < 1.5 / 127.5, f"libjpeg decode differs from PIL by {pil_err}")
    else:
        pil_err = 0.0
        check(plain_err < 1.5 / 127.5, f"PIL's resize differs from the plain one by {plain_err}")
    report = dict(decoder=decoder, name=name, images=len(files), size=size,
                  ms_per_image=1e3 * decode_s / len(files), plain_max_abs_diff=plain_err,
                  pil_max_abs_diff=pil_err)
    print(f"decoder: {report}", flush=True)
    return report


def check_native_prefetch(tmp: Path):
    """The native prefetcher against the Python path on the same paths: 3 batches of 8
    flagship phase-6 volumes (32x128x128, normalized by mean 0.5 / stddev 2), f32 and bf16,
    bit for bit, each landing pinned; the wall time of the 3 batches each way, after a
    first pass of each that warms the page cache and the pinned-memory pool."""
    d = tmp / "128x128"
    d.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(12):
        np.save(d / f"{i:03d}.npy", rng.standard_normal((32, 128, 128), dtype=np.float32))
    report = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float32, torch.bfloat16):
        stream = NumpyPathDataset(str(d), seed=3)
        python = NumpyPathDataset(str(d), seed=3)
        t0 = time.perf_counter()
        pf = native.NativeBatchPrefetcher(lambda: stream.batch_paths(8), stream.shape, 0.5, 2.0,
                                          out_dtype=dtype, pin_memory=True)
        try:
            got = [next(pf) for _ in range(3)]
        finally:
            pf.stop()
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [torch.from_numpy(np.ascontiguousarray(normalize_numpy(
            python.batch(8), 0.5, 2.0), np.float32)).to(dtype) for _ in range(3)]
        python_s = time.perf_counter() - t0
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        check(all(g.is_pinned() and g.dtype == dtype and torch.equal(g.view(bits), w.view(bits))
                  for g, w in zip(got, want)),
              f"native prefetcher ({dtype}): batches differ from the Python path's")
        report[str(dtype)[6:]] = dict(native_s=native_s, python_s=python_s)  # the second
    print(f"native prefetcher: f32 and bf16 batches bit-equal to the Python path's, pinned; "
          f"3 batches of 8 volumes {report}", flush=True)
    return report


def two_d_args(data: Path, logdir: Path):
    return [str(data) if a == "<data>" else a for a in TWO_D_ARGS] + ["--logdir", str(logdir)]


def two_d_config():
    return cli.config_from_args(cli.build_parser().parse_args(
        two_d_args(Path("unused"), Path("unused")))).finalize()


def run_two_d_trainer(data: Path, logdir: Path):
    """The 2-D pgan through ``cli.main`` from phase 6 into phase 7, counts set to 0 just
    before and read just after."""
    zero_counts()
    tee = _Tee(sys.stdout, re.compile(r"JPEG decoder|Input pipeline"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        cli.main(two_d_args(data, logdir))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["plain"] == 0, f"2-D trainer: {counts['plain']} plain-version calls")
    check(counts["fused"] > 0 and counts["fused_grad"] > 0,
          f"2-D trainer: #4 forward / backward not launched ({counts})")
    check(counts["forward"] == counts["dgrad"] == counts["wgrad"] == 0,
          f"2-D trainer: a conv kernel launched at rank 2 ({counts})")
    log = [line for _, line in tee.hits]
    check(any(line.startswith("JPEG decoder: ") for line in log), f"2-D trainer log: {log}")
    first, last = TWO_D_PHASES
    params = {}
    for p in (first, last):
        check((logdir / f"model_{p}.npz").is_file(), f"2-D trainer: model_{p}.npz not written")
        params[p], _, _ = ckpt.load_params(str(logdir / f"model_{p}.npz"), "cpu")
        convs = {k: tuple(v.shape) for k, v in params[p].items() if k.endswith("/weight")
                 and v.ndim == 4}
        check(convs and all(s[:2] in ((3, 3), (1, 1)) for s in convs.values())
              and all(v.ndim <= 4 for v in params[p].values())
              and all(torch.isfinite(v).all() for v in params[p].values()),
              f"2-D trainer: model_{p}.npz weights {convs}")
    # the cadence checkpoint after phase 7's mixing half
    c7, _, _ = ckpt.load_params(
        str(logdir / f"model_{last}_ckpt_{TWO_D_LAST_START + TWO_D_NIMG}.npz"), "cpu")
    shared = [k for k in params[first] if k in c7]
    check(all(f"_rgb_{first - 1}/" in k for k in params[first] if k not in c7)
          and all(torch.equal(c7[k], params[first][k]) for k in shared) and shared,
          "2-D trainer: phase 7 did not keep model_6's weights through its frozen mixing half")
    events = _events(logdir)
    pipelines = [e["text"] for e in events if e["tag"] == "config/input_pipeline"]
    check(pipelines == ["python_thread"] * 2, f"2-D trainer pipelines {pipelines}")
    report = dict(wall_s=wall_s, launches=counts, log=log, phases={})
    for p, lo, hi in ((first, 0, TWO_D_LAST_START), (last, TWO_D_LAST_START, 10 ** 9)):
        ev = [e for e in events if lo <= e["step"] < hi]
        after = [e for e in events if lo < e["step"] <= hi]
        for tag in ("Loss/d_loss", "Loss/g_loss", "Loss/gp"):
            vals = [e["value"] for e in ev if e["tag"] == tag]
            check(vals and all(math.isfinite(v) for v in vals), f"2-D phase {p}: {tag} {vals}")
        row = {}
        for half in ("mixing", "stabilizing"):
            ms = [e["value"] for e in ev if e["tag"] == f"Timing/step_ms_{half}"]
            check(len(ms) >= 2, f"2-D phase {p} {half}: {len(ms)} timed steps")
            row[f"{half}_ms_per_step"] = statistics.median(ms[1:])
            row[f"{half}_ms_all"] = ms
        img_s = [e["value"] for e in after if e["tag"] == "img_s" and e["value"] > 0]
        row["img_s"] = img_s[-1] if img_s else None
        row["peak_mib"] = [e["value"] for e in after
                           if e["tag"] == "memory/phase_peak_bytes"][0] / 2 ** 20
        row["input_wait_ms"] = [e["value"] for e in after
                                if e["tag"] == "Timing/input_wait_ms"][0]
        report["phases"][p] = row
        print(f"2-D phase {p} (batch {TWO_D_BATCH[p]}): mixing {row['mixing_ms_per_step']:.2f} "
              f"ms/step, stabilizing {row['stabilizing_ms_per_step']:.2f} ms/step (median after "
              f"the first, CUDA events; all {[round(v, 2) for v in row['mixing_ms_all']]} / "
              f"{[round(v, 2) for v in row['stabilizing_ms_all']]}), img/s {row['img_s']}, "
              f"peak {row['peak_mib']:.0f} MiB, input wait {row['input_wait_ms']:.3f} ms/step",
              flush=True)
    print(f"2-D trainer: {wall_s:.1f} s wall for phases {first} and {last}, launches {counts}",
          flush=True)
    return report


def serve_two_d(model_path: Path, cfg):
    """The phase-7 EMA generator served at batch 8 in f32: 4 concurrent requests of RGB
    256^2 images, counts set to 0 just before and read just after."""
    phase = TWO_D_PHASES[1]
    image = list(cfg.current_shape(phase, 1)[1:])
    service = GeneratorService.from_checkpoint("pgan", str(model_path), cfg=cfg, phase=phase,
                                               batch_size=8, device="cuda")
    srv = make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        service.warmup()
        check(_get(url + "/info")["volume_shape"] == image, "2-D info shape")
        batches0 = service.stats["batches"]
        zero_counts()
        results, errors = {}, []

        def client(num, seed):
            try:
                results[seed] = _post(url + "/generate", {"num_samples": num, "seed": seed})
            except Exception as e:  # noqa: BLE001 (reported by the check below)
                errors.append(f"seed {seed}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=r) for r in TWO_D_REQUESTS]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads), f"2-D requests: {errors}")
        counts = read_counts()
        stats = _get(url + "/stats")
        dispatches = stats["batches"] - batches0
        convs_per_forward = 1 + 2 * (phase - 1)
        check(stats["max_requests_coalesced"] >= 2, f"2-D serve: no coalescing: {stats}")
        check(counts["fused"] == convs_per_forward * dispatches and counts["plain"] == 0
              and counts["forward"] == 0,
              f"2-D serve: {counts} over {dispatches} dispatches")
        for num, seed in TWO_D_REQUESTS:
            v = np.load(io.BytesIO(results[seed]))
            check(v.shape == (num, *image) and v.dtype == np.float32 and np.isfinite(v).all(),
                  f"2-D serve seed {seed}: shape {v.shape}, finite {np.isfinite(v).all()}")
            alone = np.load(io.BytesIO(_post(url + "/generate",
                                             {"num_samples": num, "seed": seed})))
            check(np.array_equal(alone, v), f"2-D serve seed {seed}: alone differs from "
                                            f"coalesced by {np.abs(alone - v).max()}")
        png = _post(url + "/generate", {"num_samples": 4, "format": "png"})
        check(png[:8] == b"\x89PNG\r\n\x1a\n", "2-D serve: png")
        g_params, _ = _load_generator_params(str(model_path), True, "cuda")
        sampler = make_keyed_sampler(cfg, phase, 8, device="cuda")
        seeds = np.arange(8, dtype=np.int32)
        forward_ms = time_ms(lambda: sampler(g_params, seeds, seeds))
        report = dict(dispatches=dispatches, launches=counts, burst_s=burst_s,
                      forward_ms=forward_ms, max_requests_coalesced=stats["max_requests_coalesced"])
        print(f"2-D serve: {dispatches} dispatches for {len(TWO_D_REQUESTS)} concurrent "
              f"requests, #4 {counts['fused']} launches ({convs_per_forward} per dispatch), "
              f"forward {forward_ms:.3f} ms/batch-8 (CUDA events), burst {burst_s:.3f} s",
              flush=True)
        return report
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()
        thread.join(timeout=30)


def two_d(detail):
    """Phase 16: the decoder, the native prefetcher, the 2-D CLI run 6 -> 7, serving its
    phase-7 generator, and #4 at every 2-D shape of the run and the server.  Returns
    (report, kernel entries: serving f32, step bf16 forward and backward)."""
    cfg = two_d_config()
    first, last = TWO_D_PHASES
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_jpegs(tmp / "jpegs")
        report["decoder"] = check_decoder(tmp / "jpegs")
        report["native_prefetch"] = check_native_prefetch(tmp / "npy")
        report["trainer"] = run_two_d_trainer(tmp / "jpegs", tmp / "run")
        report["serve"] = serve_two_d(tmp / "run" / f"model_{last}.npz", cfg)
    serve_shapes = serving_shapes(cfg, last, 8)[0]
    shapes = {p: serving_shapes(cfg, p, TWO_D_BATCH[p])[0] for p in TWO_D_PHASES}
    check(len(serve_shapes) == 1 + 2 * (last - 1), f"2-D serving shapes {serve_shapes}")
    serve_entry = check_fused(serve_shapes, detail)
    check_train_fused(shapes[first], detail)  # held, and timed in the detail
    train_fwd, train_bwd = check_train_fused(shapes[last], detail)
    return report, (serve_entry, train_fwd, train_bwd)


def two_d_entries(report, entries):
    serve_entry, train_fwd, train_bwd = entries
    launches = report["trainer"]["launches"]
    last = TWO_D_PHASES[1]
    per_serve = (f"one 2-D phase-{last} batch-8 f32 serving forward (sum over its launches); "
                 f"launches counted over {report['serve']['dispatches']} dispatches")
    per_step = (f"one 2-D phase-{last} batch-8 bf16 train step's G forward / backward (sum over "
                f"its shapes); launches counted over the CLI run of phases 6 and 7, summaries "
                f"included")
    return [("fused_bias_act_pixelnorm[serve,2d,f32]", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:112", serve_entry,
             report["serve"]["launches"]["fused"], None, per_serve,
             report["serve"]["dispatches"]),
            ("fused_bias_act_pixelnorm[train,2d,bf16]", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:112", train_fwd, launches["fused"], None,
             per_step, None),
            ("fused_bias_act_pixelnorm_grad[train,2d,bf16]", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:123", train_bwd, launches["fused_grad"], None,
             per_step, None)]

# the evidence phase: the quality-evidence drivers' --smoke runs on the card (phases 1 -> 2,
# toy budgets), the in-process ones first: (name, module, arguments, trajectory file)
EVIDENCE_IN_PROCESS = (
    ("flagship", "convergence_run_flagship", ["2"], "trajectory_p1-2.json"),
    ("cubic", "convergence_run", ["2"], "trajectory.json"),
    ("2d", "convergence_run_2d", ["2"], "trajectory_2d.json"),
    ("families", "family_chip_smoke", [], None),
    ("hpo", "hpo_chip_demo", ["2"], None),
)


def _evidence_driver(module: str, argv, log: Path) -> float:
    """``saragan_tpu_torch.scripts.<module>.main(argv)`` in process, its output to `log`;
    it must return 0.  Returns its seconds."""
    import importlib

    mod = importlib.import_module(f"saragan_tpu_torch.scripts.{module}")
    t0 = time.perf_counter()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = mod.main([str(a) for a in argv])
    seconds = time.perf_counter() - t0
    check(rc == 0, f"evidence: {module} {argv} exited {rc}; see {log}")
    return seconds


def evidence(detail):
    """The evidence phase (the module's phase 16b).  Returns (report, launches of the
    in-process runs, (the conv kernels' entries at their shapes, #4's entries))."""
    logs = OUT_DIR / "evidence"
    logs.mkdir(parents=True, exist_ok=True)
    report = dict(seconds={}, gates={})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        zero_counts()
        for name, module, args, _ in EVIDENCE_IN_PROCESS:
            report["seconds"][name] = _evidence_driver(
                module, [tmp / name, *args, "--smoke"], logs / f"{name}.log")
        torch.cuda.synchronize()
        launches = read_counts()
        shapes = (Counter(cf.conv3d_flat_cuda.by_shape),
                  Counter(cf.conv3d_flat_wgrad_cuda.by_shape))
        check(launches["plain"] == 0, f"evidence: {launches['plain']} plain-version calls")
        for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad"):
            check(launches[k] > 0, f"evidence: kernel {k} not launched ({launches})")
        check(launches["conv_simt"] == launches["wgrad_simt"] == 0
              and launches["conv_tc"] == launches["forward"] + launches["dgrad"],
              f"evidence (bf16): routes {launches}")
        # the gates on the smoke trajectories: reported, not enforced on a toy budget
        for name, _, _, traj in EVIDENCE_IN_PROCESS[:3]:
            t = json.loads((tmp / name / traj).read_text())["trajectory"]
            two_d = name == "2d"
            smoke = gates.smoke_gate(t, gates.LAST_SUFFIXES_2D if two_d
                                     else gates.LAST_SUFFIXES)
            check(smoke.ok, f"evidence: {name} smoke gate {smoke.failures}")
            gate = (gates.caps_gate_2d(t) if two_d
                    else gates.band_gate(t, require_final_improved=name == "cubic"))
            report["gates"][name] = dict(gate=gate.gate, ok=gate.ok, summary=gate.summary())
            print(f"evidence {name}: {report['seconds'][name]:.1f} s; {gate.summary()}",
                  flush=True)
        fam = json.loads((tmp / "families" / "family_smoke.json").read_text())
        report["families"] = {r["arch"]: [r["first_moment_err"], r["last_moment_err"]]
                              for r in fam}
        check(all(r["losses_finite"] for r in fam), "evidence: a family's losses not finite")
        print(f"evidence families: {report['seconds']['families']:.1f} s; moment errors "
              f"{report['families']}; hpo: {report['seconds']['hpo']:.1f} s", flush=True)
        # the driver that runs subprocesses: the preemption receipt at its smoke budget
        report["seconds"]["preemption_receipt"] = _evidence_driver(
            "preemption_receipt", [tmp / "receipt", "--smoke"], logs / "preemption_receipt.log")
        report["receipt"] = (tmp / "receipt" / "receipt.txt").read_text()
        print(f"evidence: preemption receipt {report['seconds']['preemption_receipt']:.1f} s: "
              f"{report['receipt'].strip().splitlines()[-1]}", flush=True)
    convs = check_train_convs(*shapes, 1, detail, (torch.bfloat16,))
    # #4 at the flagship smoke generator's shapes, phases 1 and 2 at their batches
    cfg = flagship_config("", "", 1, 2, 42, True, 0.0, 1.0)
    fused = check_train_fused([s for p in (1, 2) for s in serving_shapes(
        cfg, p, cfg.batch_size_for_phase(p))[0]], detail)
    report["launches"] = launches
    return report, launches, (convs, fused)


def evidence_entries(kernels, launches):
    """The kernels line's rows of the evidence drivers' path."""
    convs, (fused, fused_grad) = kernels
    per = ("the evidence drivers' in-process --smoke runs on the card (flagship, cubic, 2-D, "
           "families, a 2-trial study): the sum over every conv shape they launched, each "
           "weighted by its launches there")
    per_fused = ("one generator forward of the flagship smoke at phase 1 (batch 8) and one at "
                 "phase 2 (batch 4): the sum over their fused shapes; launches counted over "
                 "the in-process --smoke runs")
    return (
        ("fused_bias_act_pixelnorm[evidence,bf16]", "cuda", FUSED_SOURCE,
         "saragan_tpu/ops/pallas_kernels.py:112", fused, launches["fused"], None, per_fused,
         None),
        ("fused_bias_act_pixelnorm_grad[evidence,bf16]", "cuda", FUSED_SOURCE,
         "saragan_tpu/ops/pallas_kernels.py:123", fused_grad, launches["fused_grad"], None,
         per_fused, None),
        ("conv3d_flat[forward,bf16,evidence]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
         "saragan_tpu/ops/pallas_conv.py:124", convs[("forward", "bfloat16")],
         launches["forward"], "library_ms", per, None),
        ("conv3d_flat[dgrad,bf16,evidence]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
         "saragan_tpu/ops/core.py:386", convs[("dgrad", "bfloat16")], launches["dgrad"],
         "library_ms", per, None),
        ("conv3d_wgrad[bf16,evidence]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad_tc.cu",
         "saragan_tpu/ops/pallas_conv.py:183", convs[("wgrad", "bfloat16")],
         launches["wgrad"], "library_ms", per, None))


# the parallel phase: data parallelism on the one card.  NCCL refuses two ranks on one
# device, so the two-rank runs use gloo (its collectives through host memory); one card
# gives no scaling number, only what the protocol costs
PARALLEL_STEPS = 3
PARALLEL_KINDS = ("forward", "dgrad", "wgrad", "fused", "fused_grad")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def parallel_nccl_world_one(phase5_per_step=None):
    """(a) The flagship step (phase 6, batch 8, bf16, flat; the mixing half) through the
    data-parallel step over an NCCL group of one: bit-equal to the plain step from the
    same state and draws, #1/#1'/#2/#4 launched as often as the plain step (and as phase
    5's, when given), the NCCL all-reduce kernel in a profiled step; the ms of both steps
    and of the all-reduce alone."""
    from saragan_tpu_torch.parallel import init_mesh
    from saragan_tpu_torch.tools.profile_parallel import allreduce_ms, state_sha

    mesh = init_mesh("cuda:0", verbose=False)
    try:
        if mesh.backend != "nccl" or mesh.world_size != 1:
            raise RuntimeError(f"expected an NCCL group of one, got {mesh.describe()}")
        cfg = bench_train_config(PHASE, BATCH)
        arch = get_architecture("pgan")
        state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=PHASE,
                                        cfg=cfg, device="cuda")
        real = real_batch(cfg, PHASE, BATCH, "cuda")
        plain = make_train_step(arch, cfg, PHASE, *opts, conv_engine="flat")
        dp = make_train_step(arch, cfg, PHASE, *opts, conv_engine="flat", mesh=mesh)
        zero_counts()
        p_state, p_m = plain(state0, real, torch.Generator("cuda").manual_seed(7), 0.5,
                             1e-3, 1e-3)
        torch.cuda.synchronize()
        plain_counts = read_counts()
        # the main path: counts set to 0 just before, read just after
        zero_counts()
        d_state, d_m = dp(state0, real, torch.Generator("cuda").manual_seed(7), 0.5, 1e-3,
                          1e-3)
        torch.cuda.synchronize()
        counts = read_counts()
        check(state_sha(d_state) == state_sha(p_state),
              "parallel (a): the DP step over NCCL at world size 1 differs from the plain step")
        check(all(torch.equal(getattr(d_m, f), getattr(p_m, f))
                  for f in ("gen_loss", "disc_loss", "gp_loss", "fake_min", "fake_max")),
              "parallel (a): the DP step's metrics differ from the plain step's")
        check(counts["plain"] == 0, f"parallel (a): {counts['plain']} plain-version calls")
        for k in PARALLEL_KINDS:
            check(counts[k] == plain_counts[k] > 0,
                  f"parallel (a): {k} launches {counts[k]}, plain step {plain_counts[k]}")
            if phase5_per_step is not None:
                check(counts[k] == phase5_per_step[k],
                      f"parallel (a): {k} launches {counts[k]}, phase 5's {phase5_per_step[k]}")
        # in turns (plain, DP, DP, plain), each side's steps chained on its own state
        rng = torch.Generator("cuda").manual_seed(8)
        plain_ms, dp_ms = [], []
        for fn, times in ((plain, plain_ms), (dp, dp_ms), (dp, dp_ms), (plain, plain_ms)):
            start = p_state if fn is plain else d_state
            end, ms, _ = run_steps(fn, start, real, rng, 0.5, PARALLEL_STEPS)
            times.extend(ms)
            if fn is plain:
                p_state = end
            else:
                d_state = end
        ar = allreduce_ms(mesh, {**state0.g_params, **state0.d_params})
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            dp(d_state, real, rng, 0.5, 1e-3, 1e-3)
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        nccl = [n for n in names if re.search(r"nccl|onerank", n, re.IGNORECASE)]
        check(nccl, f"parallel (a): no NCCL kernel in a profiled DP step; kernels {names[:60]}")
    finally:
        mesh.close()
    report = dict(plain_step_ms=plain_ms, dp_step_ms=dp_ms, allreduce=ar, nccl_kernels=nccl,
                  launches_per_step={k: counts[k] for k in PARALLEL_KINDS}, bit_equal=True)
    print(f"parallel (a) NCCL world 1: DP step {statistics.median(dp_ms):.2f} ms against the "
          f"plain step's {statistics.median(plain_ms):.2f} (medians of {2 * PARALLEL_STEPS} in "
          f"turns, CUDA events), bit-equal; all-reduce alone {ar['ms']:.3f} ms for {ar['mbytes']:.1f} MB; "
          f"launches per step {report['launches_per_step']}; NCCL kernels {nccl}", flush=True)
    return report


def parallel_ranks(tmp: Path, world: int = 2, one_card: bool = True):
    """(b) `world` ranks: on the one card over gloo (`one_card`), else one card each over
    NCCL.  ``tools.profile_parallel`` through torchrun (the DP step against the one-process
    step on the rank-major 8 x `world` rows, f32 and bf16, the ranks bit-equal, the halo
    conv against #1 on the whole volume), then the CLI with ``--horovod`` from phase 5 to
    6 on the ranks launched as torchrun launches them."""
    out = OUT_DIR / "profile_parallel.json"
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    device = ["--device", "cuda:0"] if one_card else []
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           str(world), "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), "-m",
           "saragan_tpu_torch.tools.profile_parallel", *device]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    tool_s = time.perf_counter() - t0
    check(run.returncode == 0 and out.is_file(),
          f"parallel (b): profile_parallel exited {run.returncode}:\n{run.stdout[-3000:]}\n"
          f"{run.stderr[-3000:]}")
    ranks = json.loads(out.read_text())
    for dt, r in ranks["steps"].items():
        check(r["ranks_bit_equal_first"] and r["ranks_bit_equal_after"],
              f"parallel (b) {dt}: the ranks differ")
        check(r["against_one_process"]["ok"],
              f"parallel (b) {dt}: the DP step against the one-process step: "
              f"{r['against_one_process']}")
    check(ranks["halo"]["ok"], f"parallel (b): halo conv {ranks['halo']}")

    cli_report = _cli_ranks(tmp, world, device, [], "parallel (b)", one_card)
    cli_s = cli_report["wall_s"]
    report = dict(tool=ranks, tool_s=tool_s, cli=cli_report)
    for dt, r in ranks["steps"].items():
        print(f"parallel (b) {ranks['backend']} x{world}, {dt}: DP step {statistics.median(r['step_ms']):.2f} ms per "
              f"rank (rank 0, median of {PARALLEL_STEPS}); all-reduce alone "
              f"{r['allreduce']['ms']:.2f} ms for {r['allreduce']['mbytes']:.1f} MB; against "
              f"the one-process step on {8 * world}: {r['against_one_process']}", flush=True)
    h = ranks["halo"]
    print(f"parallel (b) halo conv x{h['x']} w{h['w']}, depth split over {world}: "
          f"{h['halo_ms']:.3f} "
          f"ms against #1 on the whole volume {h['whole_ms']:.3f} ms; max|err| "
          f"{h['max_abs_err']:.3g} of {h['scale']:.3g}, bit-equal {h['bit_equal']}; #1 on the "
          f"extended slab {h['kernel']['ms']:.3f} ms; CLI 5 -> 6 on {world} ranks {cli_s:.1f} s, "
          f"model_6 equal", flush=True)
    return report


def _cli_ranks(tmp: Path, world: int, device, extra, label, one_card=True):
    """The CLI with ``--horovod`` (and `extra`) from phase 5 to 6 on `world` ranks launched
    as torchrun launches them: every rank exits 0, model_6.npz equal on all, rank 0 alone
    writes events, finite losses, the transport line in the log."""
    write_dataset(tmp / "data")
    port = str(_free_port())
    procs = {r: _cli_process(trainer_args(tmp / "data", tmp / f"rank{r}", "--horovod",
                                          *device, *extra),
                             env=dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                                      MASTER_PORT=port))
             for r in range(world)}
    t0 = time.perf_counter()
    done = _finish(procs, timeout=400)
    cli_s = time.perf_counter() - t0
    for r, (rc, text) in done.items():
        check(rc == 0, f"{label}: CLI rank {r} exited {rc}:\n{text[-3000:]}")
    line = (f"Data parallel: {world} process(es); rank 0 of {world} on cuda:0, " +
            ("gloo collectives over host memory" if one_card else
             "nccl collectives over the device"))
    check(line in done[0][1], f"{label}: the transport line: {done[0][1][:2000]}")
    shas = []
    for r in range(world):
        for p in (5, 6):
            check((tmp / f"rank{r}" / f"model_{p}.npz").is_file(),
                  f"{label}: rank {r} wrote no model_{p}.npz")
        h = hashlib.sha256()
        with np.load(tmp / f"rank{r}" / f"model_{PHASE}.npz") as z:
            for k in sorted(z.files):
                h.update(k.encode())
                h.update(z[k].tobytes())
        shas.append(h.hexdigest())
    check(len(set(shas)) == 1, f"{label}: the ranks' model_6.npz differ")
    check(not any((tmp / f"rank{r}" / "events.jsonl").exists() for r in range(1, world)),
          f"{label}: a rank other than 0 wrote events")
    events = _events(tmp / "rank0")
    losses_ = [e["value"] for e in events if e["tag"] in ("Loss/d_loss", "Loss/g_loss")]
    check(losses_ and all(math.isfinite(v) for v in losses_), f"{label}: losses {losses_}")
    steps = {h: [e["value"] for e in events if e["tag"] == f"Timing/step_ms_{h}"]
             for h in ("mixing", "stabilizing")}
    return dict(wall_s=cli_s, params_sha=shas[0], step_ms=steps)


def parallel_serving(cards: int = 1):
    """(c) On one card, ``--serve_devices 2`` raises ValueError and the keyed sampler's rows
    split over [cuda:0, cuda:0]; on `cards` > 1, ``--serve_devices cards`` serves on
    cuda:0 .. and the rows split over those cards.  Either way the split gives one device's
    batch bit for bit, through #1 and #4 (counts set to 0 just before, read just after)."""
    cfg = Config(**BENCH_CFG, starting_phase=PHASE, ending_phase=PHASE).finalize()
    params = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=PHASE,
                                           cfg=cfg, device="cuda")
    g = {k: v for k, v in params.items() if k.startswith("generator/")}
    n = max(cards, 2)
    devices = [f"cuda:{i}" for i in range(cards)] if cards > 1 else ["cuda:0", "cuda:0"]
    message = None
    with tempfile.TemporaryDirectory() as tmp:
        model = ckpt.save_params(str(Path(tmp) / f"model_{PHASE}"), params, ema=params)
        try:
            service = GeneratorService.from_checkpoint("pgan", model, cfg=cfg, phase=PHASE,
                                                       n_devices=n, conv_engine="flat")
        except ValueError as e:
            message = str(e)
    if cards > 1:
        check(message is None and service.info["devices"] == devices,
              f"parallel (c): --serve_devices {n} on {cards} cards: {message}")
    else:
        check(message is not None and "--serve_devices 2" in message,
              f"parallel (c): --serve_devices 2 on one card: {message}")
    seeds, idxs = np.array([101, 101, 102, 103, 104, 105, 106, 107]), np.arange(8)
    one = make_keyed_sampler(cfg, PHASE, 8, device="cuda:0", conv_engine="flat")
    split = make_keyed_sampler(cfg, PHASE, 8, device=devices, conv_engine="flat")
    ref = one(g, seeds, idxs)
    zero_counts()
    got = split(g, seeds, idxs)
    torch.cuda.synchronize()
    counts = read_counts()
    check(torch.equal(got, ref), f"parallel (c): the row split differs from one device by "
                                 f"{(got - ref).abs().max().item()}")
    check(counts["forward"] > 0 and counts["fused"] > 0 and counts["plain"] == 0,
          f"parallel (c): launches {counts}")
    one_ms = time_ms(lambda: one(g, seeds, idxs), reps=10)
    split_ms = time_ms(lambda: split(g, seeds, idxs), reps=10)
    print(f"parallel (c): --serve_devices {n} " + ("refused" if message else "served") +
          f" ({message or devices}); rows split over {devices} bit-equal to one device, "
          f"{split_ms:.2f} ms a batch of 8 against {one_ms:.2f}; launches "
          f"{counts['forward']} #1, {counts['fused']} #4", flush=True)
    return dict(refused=message, devices=devices, bit_equal=True, one_ms=one_ms,
                split_ms=split_ms, launches=dict(forward=counts["forward"],
                                                 fused=counts["fused"]))


# the four-rank (space 2 x space2 2) run's phase: 5 until the script neared its time limit,
# 4 until the evidence phase needed the time
SPACE_PHASE4 = 3
# (f): pgan2, pgandeep, stylegan and stylegan2 sharded at 4 x 16^2 (phase 5, 16 x 64^2,
# until the engines phase needed the time; phase 4, 8 x 32^2, until the evidence phase did)
SPACE_FAMILY_PHASE = 3
# (e): the remat / remat_offload lever check's phase (6, the flagship's 32 x 128^2, until the
# resume pair came back beside the evidence phase)
LEVER_PHASE = 5
# (f): surfgan sharded at 16 x 64^2 (phase 6, the flagship's 32 x 128^2, until the evidence
# phase needed the time)
SPACE_SURFGAN_PHASE = 5


def _space_tool(world: int, out: Path, *extra, device=("--device", "cuda:0"), timeout=400):
    """``tools.profile_parallel`` in its spatial mode on `world` ranks: gloo ranks sharing
    cuda:0, or with `device` () a card each over NCCL; returns (report, seconds)."""
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           str(world), "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), "-m",
           "saragan_tpu_torch.tools.profile_parallel", *device, "--out", str(out), *extra]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    check(run.returncode == 0 and out.is_file(),
          f"parallel (d): profile_parallel {' '.join(extra)} exited {run.returncode}:\n"
          f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    return json.loads(out.read_text()), time.perf_counter() - t0


def _space_checked(steps, label):
    """Every check of one spatial run's steps ({dtype: report}), and its lines."""
    for dt, r in steps.items():
        check(r["ranks_bit_equal_first"] and r["ranks_bit_equal_after"],
              f"parallel (d) {label} {dt}: the ranks differ")
        check(r["against_one_process"]["ok"],
              f"parallel (d) {label} {dt}: against the one-process step: "
              f"{r['against_one_process']}")
        kinds = PARALLEL_KINDS if r.get("needs_fused", True) else PARALLEL_KINDS[:3]
        for rank, c in enumerate(r["launches_by_rank"]):
            check(min(c[k] for k in kinds) > 0 and c["plain"] == 0,
                  f"parallel (d) {label} {dt}: rank {rank} launches {c}")
        ex = r["exchanges"]
        print(f"parallel (d) {label} {dt}: slab {r['slab']}, step "
              f"{statistics.median(r['step_ms']):.2f} ms per rank (rank 0, median of "
              f"{len(r['step_ms'])}, CUDA events); exchanges {ex['ms']:.2f} ms of an "
              f"instrumented step's {ex['instrumented_step_ms']:.2f} ({100 * ex['share']:.1f} "
              f"%, {ex['calls']} calls); launches per rank {r['launches_by_rank']}; against "
              f"the one-process step {r['against_one_process']}; against the one-process step "
              f"with f64 activations {r.get('f64')}",
              flush=True)


def parallel_space(tmp: Path, detail):
    """(d) Spatial sharding on gloo ranks sharing the card (see the module's phase 17)."""
    two, two_s = _space_tool(2, OUT_DIR / "profile_parallel_space.json", "--space", "2",
                             "--phase", str(PHASE))
    check(two["layout"] == [1, 2, 1], f"parallel (d): layout {two['layout']}")
    _space_checked(two["steps"], "data 1 x space 2")
    four, four_s = _space_tool(4, OUT_DIR / "profile_parallel_space4.json", "--space", "2",
                               "--space2", "2", "--phase", str(SPACE_PHASE4), "--f32_only")
    check(four["layout"] == [1, 2, 2], f"parallel (d): layout {four['layout']}")
    _space_checked(four["steps"], "data 1 x space 2 x space2 2")
    cli_report = _cli_ranks(tmp, 2, ["--device", "cuda:0"], ["--num_space_shards", "2"],
                            "parallel (d)")
    # #1, #1' and #2 at every conv shape of the two-rank bf16 step's slabs (rank 0's)
    shapes = two["steps"]["bfloat16"]["shapes"]
    conv_shapes = Counter({tuple(tuple(v) if isinstance(v, list) else v for v in k): n
                           for k, n in shapes["conv"]})
    wgrad_shapes = Counter({tuple(tuple(v) if isinstance(v, list) else v for v in k): n
                            for k, n in shapes["wgrad"]})
    crops = {(tuple(spatial), tuple(kernel)): r for (spatial, kernel), r in shapes["halo_crops"]}
    convs = check_train_convs(conv_shapes, wgrad_shapes, 1, detail, dtypes=(torch.bfloat16,),
                              crops=crops)
    launches = two["steps"]["bfloat16"]["launches_by_rank"][0]
    print(f"parallel (d): tool {two_s:.1f} s (2 ranks) + {four_s:.1f} s (4 ranks), CLI 5 -> 6 "
          f"on 2 ranks {cli_report['wall_s']:.1f} s, model_6 equal", flush=True)
    return dict(two_ranks=two, four_ranks=four, cli=cli_report, tool_s=[two_s, four_s]), (
        convs, launches)


def _tool_shapes(step_report, keep=lambda xs: True):
    """(conv shapes, wgrad shapes, halo crops) of a ``profile_parallel`` spatial step report
    (rank 0's launches of one step), the shapes whose input `keep` takes."""
    def key(k):
        return tuple(tuple(v) if isinstance(v, list) else v for v in k)

    shapes = step_report["shapes"]
    conv = Counter({key(k): n for k, n in shapes["conv"] if keep(k[1])})
    wgrad = Counter({key(k): n for k, n in shapes["wgrad"] if keep(k[0])})
    crops = {(tuple(spatial), tuple(kernel)): r for (spatial, kernel), r in shapes["halo_crops"]}
    return conv, wgrad, crops


def _space_memory_line(r):
    mem = r["memory_by_rank"]
    return ", ".join(f"rank {i}: peak {m['peak_mib']:.0f} MiB, parked {m['parked_mib']:.0f} MiB"
                     for i, m in enumerate(mem))


def parallel_space_levers(detail):
    """(e) The phase-8 batch-2 single_chip_big_volume preset step (the flagship's widths,
    128 x 512^2, C = 8 at the top) with each volume's depth split 64 + 64 over two gloo
    ranks sharing the card, bf16, against the one-process preset step from the same state
    and draws (``compare_states(space=True)``: the bf16 margin against the one-process f32
    step); ms, peak and parked MiB and the kernels' launches per rank; the ranks bit-equal;
    first, the phase-5 sharded step under remat and under remat_offload bit-equal to the
    sharded plain step, f32 and bf16.  Then #1, #1' and #2 at every 512^2 conv shape of
    rank 0's slabs and #4 at the slab's two 64 x 512^2 layers.  Returns (report, kernel
    entries, launches)."""
    t0 = time.perf_counter()
    rep, tool_s = _space_tool(2, OUT_DIR / "profile_parallel_space_levers.json", "--space", "2",
                              "--phase", str(BIG_PHASE), "--batch", str(BIG_BATCH),
                              "--single_chip_big_volume", "--bf16_only", "--lever_check",
                              str(LEVER_PHASE), timeout=600)
    check(rep["layout"] == [1, 2, 1] and rep["levers"] == ["single_chip_big_volume"],
          f"parallel (e): layout {rep['layout']}, levers {rep['levers']}")
    _space_checked(rep["steps"], "phase 8 preset, data 1 x space 2")
    r = rep["steps"]["bfloat16"]
    for i, m in enumerate(r["memory_by_rank"]):
        check(m["parked_mib"] > 0, f"parallel (e): rank {i} parked nothing: {m}")
    for c in rep["lever_check"]:
        check(c["bit_equal_all_ranks"] and c["ranks_equal"] and min(c["parked_mib_by_rank"]) > 0,
              f"parallel (e): phase-{c['phase']} {c['dtype']} levers not bit-equal: {c}")
    print(f"parallel (e): phase {BIG_PHASE} preset step, depth 64 + 64: {_space_memory_line(r)} "
          f"(one process: peak 9.2 GiB, 7166 MiB parked); levers at phase {LEVER_PHASE} "
          f"bit-equal: {[(c['dtype'], c['bit_equal']) for c in rep['lever_check']]}",
          flush=True)
    conv_shapes, wgrad_shapes, crops = _tool_shapes(r, lambda xs: tuple(xs[3:]) ==
                                                    BIG_SPATIAL[1:])
    check(conv_shapes and wgrad_shapes, "parallel (e): no 512^2 slab conv shapes")
    convs = check_train_convs(conv_shapes, wgrad_shapes, 1, detail, dtypes=(torch.bfloat16,),
                              crops=crops)
    fs = bench_train_config(BIG_PHASE, BIG_BATCH).resolved_filter_spec()[BIG_PHASE - 1]
    slab_spatial = (BIG_SPATIAL[0] // 2, *BIG_SPATIAL[1:])
    fused = check_train_fused([(BIG_BATCH, c, *slab_spatial) for c in fs], detail)
    rep["seconds"] = time.perf_counter() - t0
    print(f"parallel (e): {rep['seconds']:.1f} s (the tool {tool_s:.1f} s)", flush=True)
    return rep, (convs, fused), r["launches_by_rank"][0]


def parallel_space_families(detail):
    """(f) surfgan at phase 5 (the flagship's widths, 16 x 64^2, batch 8) with each
    volume's depth split 8 + 8 over two gloo ranks, f32 and bf16, and pgan2, pgandeep,
    stylegan and stylegan2 at phase 3 (4 x 16^2, depth 2 + 2), f32, each against the
    one-process step within ``compare_states(space=True)``'s limits (f32 with the f64
    witness); ms per rank, the exchanges' share and launches per rank.  Then #1, #1' and
    #2 at every conv shape of surfgan's bf16 slabs.  Returns (report, kernel entries,
    launches)."""
    t0 = time.perf_counter()
    sg, sg_s = _space_tool(2, OUT_DIR / "profile_parallel_space_surfgan.json", "--space", "2",
                           "--phase", str(SPACE_SURFGAN_PHASE), "--architecture", FAMILY)
    _space_checked(sg["steps"], f"{FAMILY} phase {SPACE_SURFGAN_PHASE}, data 1 x space 2")
    others, others_s = _space_tool(2, OUT_DIR / "profile_parallel_space_families.json",
                                   "--space", "2", "--phase", str(SPACE_FAMILY_PHASE),
                                   "--architecture", ",".join(OTHER_FAMILIES), "--f32_only")
    for name in OTHER_FAMILIES:
        _space_checked(others["runs"][name],
                       f"{name} phase {SPACE_FAMILY_PHASE}, data 1 x space 2")
    r = sg["steps"]["bfloat16"]
    conv_shapes, wgrad_shapes, crops = _tool_shapes(r)
    convs = check_train_convs(conv_shapes, wgrad_shapes, 1, detail, dtypes=(torch.bfloat16,),
                              crops=crops)
    report = dict(surfgan=sg, others=others, tool_s=[sg_s, others_s],
                  seconds=time.perf_counter() - t0)
    print(f"parallel (f): {report['seconds']:.1f} s (the tools {sg_s:.1f} + {others_s:.1f} s)",
          flush=True)
    return report, convs, r["launches_by_rank"][0]


def parallel(phase5_per_step=None, detail=None):
    """Phase 17.  Returns (report, the kernel rows' inputs: the halo conv's entry and
    launches, the spatial step's conv entries and launches; those of parts (e) and (f))."""
    detail = [] if detail is None else detail
    report = dict(nccl_world_one=parallel_nccl_world_one(phase5_per_step))
    with tempfile.TemporaryDirectory() as tmp:
        report["two_ranks"] = parallel_ranks(Path(tmp))
    report["serving"] = parallel_serving()
    with tempfile.TemporaryDirectory() as tmp:
        report["space"], space = parallel_space(Path(tmp), detail)
    report["space_levers"], *levers = parallel_space_levers(detail)
    report["space_families"], *fams = parallel_space_families(detail)
    halo = report["two_ranks"]["tool"]["halo"]
    return report, (halo["kernel"], halo["launches"], *space), (levers, fams)


def parallel_entries(entry, launches, space_convs, space_launches):
    per = (f"the local conv of the depth-halo conv (parallel.halo_conv3d, engine flat) at the "
           f"phase-{PHASE} batch-{BATCH} last generator conv, f32, depth split over two gloo "
           f"ranks on one card: one rank's extended slab (ms and bound for its own output "
           f"slices); launches of that halo call on rank 0")
    per_space = (f"one phase-{PHASE} batch-{BATCH} bf16 train step under flat with each "
                 f"volume's depth split 16 + 16 over two gloo ranks on one card: rank 0's "
                 f"launches at every conv shape of its extended slabs (sum over them; bound "
                 f"and operations for the cropped outputs); "
                 f"launches counted over that one step on rank 0")
    return [("conv3d_flat[halo,f32]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd.cu",
             "saragan_tpu/ops/pallas_conv.py:124", entry, launches, "library_ms", per, None),
            ("conv3d_flat[forward,bf16,space]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
             "saragan_tpu/ops/pallas_conv.py:124", space_convs[("forward", "bfloat16")],
             space_launches["forward"], "library_ms", per_space, 1),
            ("conv3d_flat[dgrad,bf16,space]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
             "saragan_tpu/ops/core.py:386", space_convs[("dgrad", "bfloat16")],
             space_launches["dgrad"], "library_ms", per_space, 1),
            ("conv3d_wgrad[bf16,space]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad_tc.cu",
             "saragan_tpu/ops/pallas_conv.py:183", space_convs[("wgrad", "bfloat16")],
             space_launches["wgrad"], "library_ms", per_space, 1)]


def space_slice_entries(levers, fams):
    """The kernels line's rows of parts (e) and (f) (either may be None): #1, #1' and #2 on
    the phase-8 preset step's slabs and #4 forward and backward there, and #1, #1' and #2
    on surfgan's phase-5 slabs, each with rank 0's launches of its part's main-path step."""
    tc_fwd, tc_wgrad = ("saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
                        "saragan_tpu_torch/csrc/conv3d_wgrad_tc.cu")

    def conv_rows(tag, convs, launches, per):
        return [(f"conv3d_flat[forward,bf16,space,{tag}]", "cuda", tc_fwd,
                 "saragan_tpu/ops/pallas_conv.py:124", convs[("forward", "bfloat16")],
                 launches["forward"], "library_ms", per, 1),
                (f"conv3d_flat[dgrad,bf16,space,{tag}]", "cuda", tc_fwd,
                 "saragan_tpu/ops/core.py:386", convs[("dgrad", "bfloat16")],
                 launches["dgrad"], "library_ms", per, 1),
                (f"conv3d_wgrad[bf16,space,{tag}]", "cuda", tc_wgrad,
                 "saragan_tpu/ops/pallas_conv.py:183", convs[("wgrad", "bfloat16")],
                 launches["wgrad"], "library_ms", per, 1)]

    rows = []
    if levers is not None:
        (convs, (fused, fused_grad)), launches = levers
        per = (f"one phase-{BIG_PHASE} batch-{BIG_BATCH} bf16 step under "
               f"single_chip_big_volume with each volume's depth split 64 + 64 over two gloo "
               f"ranks on one card: rank 0's launches at the 512^2 shapes of its extended "
               f"slabs (sum over them; bound and operations for the cropped outputs; #4 at "
               f"the slab's two 64 x 512^2 layers); launches counted over that one step on "
               f"rank 0, every shape")
        rows += conv_rows("phase8", convs, launches, per)
        rows += [("fused_bias_act_pixelnorm[space,phase8,bf16]", "cuda", FUSED_SOURCE,
                  "saragan_tpu/ops/pallas_kernels.py:112", fused, launches["fused"], None,
                  per, 1),
                 ("fused_bias_act_pixelnorm_grad[space,phase8,bf16]", "cuda", FUSED_SOURCE,
                  "saragan_tpu/ops/pallas_kernels.py:123", fused_grad, launches["fused_grad"],
                  None, per, 1)]
    if fams is not None:
        convs, launches = fams
        depth = 2 ** (SPACE_SURFGAN_PHASE - 1) // 2
        per = (f"one phase-{SPACE_SURFGAN_PHASE} batch-{BATCH} bf16 {FAMILY} step under flat "
               f"with each volume's depth split {depth} + {depth} over two gloo ranks on one "
               f"card: rank 0's "
               f"launches at every conv shape of its extended slabs (sum over them; bound and "
               f"operations for the cropped outputs); launches counted over that one step "
               f"on rank 0")
        rows += conv_rows(FAMILY, convs, launches, per)
    return rows


# the engines phase: the flagship step under each conv formulation of the JAX package's
# SARAGAN_CONV3D besides direct and flat (gemm_custom under both of its wgrads)
ENGINES = {"flat_v2": Ops("flat_v2"), "gemm": Ops("gemm"), "gemm_custom": Ops("gemm_custom"),
           "gemm_custom_einsum": Ops("gemm_custom", wgrad="einsum"), "hybrid": Ops("hybrid"),
           "s2d": Ops("s2d")}
ENGINE_STEPS = 3
# kernel #1's launches a flagship step under flat (PERF.md section 4), which #3's under
# flat_v2 must equal
FLAT_PER_STEP = {"forward": 28, "dgrad": 39}
SERVE_ENGINES = ("direct", "s2d", "gemm")
PRESET_OPS = {"preset": Ops("flat"), "window_compute": Ops("flat", pool="window",
                                                            stats="compute")}


def _v2_by_role(by_shape, per):
    """#3's launches of `by_shape` (since the counts were set to 0) as check_conv_v2's
    items, {role: [(role, x shape, w shape, launches / per)]}, and {role: launches}."""
    items, launches = {}, Counter()
    for (role, xs, ws, _), n in sorted(by_shape.items(), key=str):
        items.setdefault(role, []).append((role, xs, ws, n / per))
        launches[role] += n
    return items, launches


def engine_step(cfg, name, state0, opts, real):
    """The flagship step's mixing half (alpha 0.5 traced) under ENGINES[name] from
    `state0`: a warm-up step, then ENGINE_STEPS steps with the counts set to 0 just before
    and read just after.  Every loss finite, no plain version; under flat_v2 kernel #3 as
    often as #1 under flat (forward and dgrad, through the tensor-core route), #1 and #2
    never; under the others no hand-written conv kernel.  Returns (row, counts, #3's
    launches by shape)."""
    step = make_train_step(get_architecture("pgan"), cfg, PHASE, *opts, static_alpha=None,
                           conv_engine=ENGINES[name])
    rng = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, _, _ = run_steps(step, state0, real, rng, 0.5, 1)  # warm-up
    zero_counts()  # the main path: counts set to 0 just before, read just after
    state, ms, metrics = run_steps(step, state, real, rng, 0.5, ENGINE_STEPS)
    counts = read_counts()
    v2_shapes = Counter(cf.conv3d_flat_v2_cuda.by_shape)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses_ = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
    check(all(math.isfinite(v) for row in losses_ for v in row),
          f"engines [{name}]: non-finite losses {losses_}")
    check(counts["plain"] == 0, f"engines [{name}]: {counts['plain']} plain-version calls")
    check(counts["forward"] == counts["dgrad"] == counts["wgrad"] == 0,
          f"engines [{name}]: kernel #1 or #2 launched: {counts}")
    check(counts["fused"] == counts["fused_grad"] == 11 * ENGINE_STEPS,
          f"engines [{name}]: fused launches {counts}")
    _, v2 = _v2_by_role(v2_shapes, ENGINE_STEPS)
    if name == "flat_v2":
        check({r: v2[r] for r in FLAT_PER_STEP} == {r: n * ENGINE_STEPS
                                                     for r, n in FLAT_PER_STEP.items()}
              and cf.launches_by_route(cf.conv3d_flat_v2_cuda)["tc"] == counts["v2"],
              f"engines [flat_v2]: #3 launches {dict(v2)} in {ENGINE_STEPS} steps, #1's "
              f"under flat {FLAT_PER_STEP} a step, all through the tensor cores")
    else:
        check(counts["v2"] == 0, f"engines [{name}]: kernel #3 launched {counts['v2']}")
    for part in ("g_params", "d_params", "ema"):
        check(_moved(getattr(state, part), getattr(state0, part)),
              f"engines [{name}]: {part} did not move")
    row = dict(step_ms=statistics.median(ms), step_ms_all=ms, peak_mib=peak_mib,
               losses=losses_[-1], v2_per_step={r: n / ENGINE_STEPS for r, n in v2.items()})
    print(f"engines [{name}]: bf16 step {row['step_ms']:.2f} ms (median of {ENGINE_STEPS}, "
          f"CUDA events; all {[round(v, 2) for v in ms]}), peak {peak_mib:.0f} MiB, losses "
          f"{losses_[-1]}, #3 per step {row['v2_per_step']}", flush=True)
    return row, counts, v2_shapes


def engine_grads_f32(name, state0, real, draws, ref):
    """One f32 gradient computation of the step under ENGINES[name] (the counts set to 0
    just before, read just after), twice: every gradient within 1e-3 * max|g| of `ref`
    (direct's), the losses within 1e-3 relative; whether the rerun is bit-equal (a
    reading).  Returns (row, counts, #3's launches by shape)."""
    cfg = bench_train_config(PHASE, BATCH, compute_dtype="float32")
    grads_fn = make_grads_fn(get_architecture("pgan"), cfg, PHASE, static_alpha=None,
                             conv_engine=ENGINES[name])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    (gg, dg), out = grads_fn(state0.g_params, state0.d_params, real, draws, 0.5)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    v2_shapes = Counter(cf.conv3d_flat_v2_cuda.by_shape)
    check(counts["plain"] == 0 and counts["forward"] == counts["dgrad"] == counts["wgrad"] == 0,
          f"engines [{name}] f32: plain versions or #1 / #2 ran: {counts}")
    if name == "flat_v2":
        check(counts["v2"] > 0 and cf.launches_by_route(cf.conv3d_flat_v2_cuda)["simt"]
              == counts["v2"], f"engines [flat_v2] f32: #3 launches {counts}")
    (gg2, dg2), _ = grads_fn(state0.g_params, state0.d_params, real, draws, 0.5)
    grads, again = {**gg, **dg}, {**gg2, **dg2}
    rerun_equal = all(torch.equal(grads[k], again[k]) for k in grads)
    (rg, rout) = ref
    loss_rel = {}
    for k in ("gen_loss", "disc_loss", "gp_loss"):
        a, b = getattr(out, k).item(), getattr(rout, k).item()
        loss_rel[k] = abs(a - b) / max(abs(b), 1e-30)
        check(abs(a - b) <= 1e-3 * abs(b) + 1e-6, f"engines [{name}] f32 {k}: {a} vs {b}")
    worst = (0.0, None)
    for k, b in rg.items():
        scale = b.abs().max().item()
        err = (grads[k] - b).abs().max().item()
        check(err <= 1e-3 * scale, f"engines [{name}] f32 gradient {k}: {err} > 1e-3 * {scale}")
        if scale > 0:
            worst = max(worst, (err / scale, k))
    row = dict(loss_rel=loss_rel, worst_grad_rel=worst[0], worst_grad=worst[1],
               rerun_bit_equal=rerun_equal, peak_mib=peak_mib)
    print(f"engines [{name}]: f32 gradients against direct's {row}", flush=True)
    return row, counts, v2_shapes


def preset_pool_stats():
    """The phase-8 batch-2 single_chip_big_volume step (bf16, the mixing half) under the
    preset's formulation and with the reference preset's window pool and compute-dtype
    statistics: a warm-up and ENGINE_STEPS steps each, ms (median) and peak MiB, finite
    losses."""
    arch = get_architecture("pgan")
    cfg = bench_train_config(BIG_PHASE, BIG_BATCH, single_chip_big_volume=True)
    state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=BIG_PHASE,
                                    cfg=cfg, device="cuda")
    real = torch.randn(cfg.current_shape(BIG_PHASE, BIG_BATCH),
                       generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    rows = {}
    for name, ops in PRESET_OPS.items():
        step = make_train_step(arch, cfg, BIG_PHASE, *opts, static_alpha=None, conv_engine=ops)
        rng = torch.Generator(device="cuda").manual_seed(6)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _, _ = run_steps(step, state0, real, rng, 0.5, 1)
        state, ms, metrics = run_steps(step, state, real, rng, 0.5, ENGINE_STEPS)
        losses_ = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
        check(all(math.isfinite(v) for row in losses_ for v in row),
              f"engines preset [{name}]: non-finite losses {losses_}")
        rows[name] = dict(step_ms=statistics.median(ms), step_ms_all=ms,
                          peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                          losses=losses_[-1])
        print(f"engines: phase-{BIG_PHASE} batch-{BIG_BATCH} preset step [{name}, pool "
              f"{ops.pool}, stats {ops.stats}]: {rows[name]['step_ms']:.2f} ms (median of "
              f"{ENGINE_STEPS}), peak {rows[name]['peak_mib']:.0f} MiB", flush=True)
        del state
    return rows


def serve_engines():
    """One phase-6 batch-8 serving forward (the keyed sampler, f32) under SERVE_ENGINES:
    volumes finite, s2d and gemm within 1e-4 * max|direct| of direct, ms per forward (CUDA
    events, median of 5 after a warm-up)."""
    cfg = Config(**BENCH_CFG, starting_phase=PHASE, ending_phase=PHASE).finalize()
    params = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=PHASE,
                                           cfg=cfg, device="cuda")
    seeds, idxs = np.arange(BATCH) + 401, np.zeros(BATCH, np.int64)
    rows, outs = {}, {}
    for engine in SERVE_ENGINES:
        sampler = make_keyed_sampler(cfg, PHASE, BATCH, device="cuda", conv_engine=engine)
        outs[engine] = sampler(params, seeds, idxs).float()
        check(torch.isfinite(outs[engine]).all().item(), f"engines serve [{engine}]: not finite")
        rows[engine] = dict(forward_ms=time_ms(lambda: sampler(params, seeds, idxs), reps=5,
                                               warmup=1))
    ref = outs["direct"]
    for engine in SERVE_ENGINES[1:]:
        err = (outs[engine] - ref).abs().max().item()
        rows[engine]["max_rel_diff"] = err / ref.abs().max().item()
        check(err <= 1e-4 * ref.abs().max().item(),
              f"engines serve [{engine}]: {err} from direct's")
    print(f"engines: phase-{PHASE} batch-{BATCH} serving forward {rows}", flush=True)
    return rows


def engines(detail):
    """The engines phase: the flagship step under every engine of ENGINES in bf16 (timed)
    and f32 (gradients against direct's), #3 against its plain version at every shape the
    flat_v2 steps gave it, the phase-8 preset step with the window pool and compute-dtype
    statistics, and a serving forward under s2d and gemm.  Returns (report, the kernels
    line's #3 entries and launches)."""
    t0 = time.perf_counter()
    gc.collect()  # what earlier phases left: the GEMM engines take tens of GiB
    torch.cuda.empty_cache()
    arch = get_architecture("pgan")
    cfg = bench_train_config(PHASE, BATCH)
    state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=PHASE,
                                    cfg=cfg, device="cuda")
    real = real_batch(cfg, PHASE, BATCH, "cuda")
    draws = losses.draw_inputs(torch.Generator(device="cuda").manual_seed(4), BATCH,
                               cfg.latent_dim, real.shape[1:], torch.float32, "cuda")
    ref_fn = make_grads_fn(arch, bench_train_config(PHASE, BATCH, compute_dtype="float32"),
                           PHASE, static_alpha=None, conv_engine="direct")
    (rg, rd), rout = ref_fn(state0.g_params, state0.d_params, real, draws, 0.5)
    ref = ({**rg, **rd}, rout)
    report, v2 = dict(steps={}, f32={}), {}
    for name in ENGINES:
        report["steps"][name], counts, shapes = engine_step(cfg, name, state0, opts, real)
        report["f32"][name], counts32, shapes32 = engine_grads_f32(name, state0, real, draws,
                                                                   ref)
        if name == "flat_v2":
            v2 = dict(bf16=(shapes, counts), f32=(shapes32, counts32))
    del state0, ref, rg, rd
    torch.cuda.empty_cache()
    items, launches = _v2_by_role(v2["bf16"][0], ENGINE_STEPS)
    items32, launches32 = _v2_by_role(v2["f32"][0], 1)
    entries = {role: check_conv_v2(items[role], torch.bfloat16, detail)
               for role in ("forward", "dgrad")}
    entries["f32"] = check_conv_v2(items32["forward"] + items32["dgrad"], torch.float32, detail)
    launches = {"forward": launches["forward"], "dgrad": launches["dgrad"],
                "f32": launches32["forward"] + launches32["dgrad"]}
    report["preset"] = preset_pool_stats()
    report["serve"] = serve_engines()
    report["seconds"] = time.perf_counter() - t0
    print(f"engines: {report['seconds']:.1f} s", flush=True)
    return report, (entries, launches)


def engine_entries(entries, launches):
    """The kernels line's rows of #3 on the flat_v2 path."""
    per = (f"kernel #3 under the flat_v2 engine (the JAX package's pallas2): one "
           f"phase-{PHASE} batch-{BATCH} bf16 train step's mixing half (sum over its launches "
           f"at that step's shapes); launches counted over {ENGINE_STEPS} steps")
    per32 = (f"kernel #3 under flat_v2 in one phase-{PHASE} batch-{BATCH} f32 gradient "
             f"computation of the train step, forward and dgrad (sum over its launches); "
             f"launches counted over that one computation")
    src, src32 = ("saragan_tpu_torch/csrc/conv3d_fwd_v2_tc.cu",
                  "saragan_tpu_torch/csrc/conv3d_fwd_v2.cu")
    return (("conv3d_flat_v2[forward,bf16]", "cuda", src, "saragan_tpu/ops/pallas_conv.py:288",
             entries["forward"], launches["forward"], "library_ms", per, ENGINE_STEPS),
            ("conv3d_flat_v2[dgrad,bf16]", "cuda", src, "saragan_tpu/ops/pallas_conv.py:288",
             entries["dgrad"], launches["dgrad"], "library_ms", per, ENGINE_STEPS),
            ("conv3d_flat_v2[forward+dgrad,f32,train]", "cuda", src32,
             "saragan_tpu/ops/pallas_conv.py:288", entries["f32"], launches["f32"],
             "library_ms", per32, 1))


def kernel_row(name, route, source, replaces, e, launches, library, per_what, unit):
    """One entry of the kernels line."""
    check(launches > 0, f"{name}: not launched")
    k = dict(name=name, route=route, source=source, replaces=replaces, launches=launches,
             max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
             bound_ms=e["bound_ms"],
             bound_by="operations" if e["t_ops"] > e["t_bytes"] else "bytes",
             library_ms=e[library] if library else None, per=per_what)
    if unit:
        k["launches_per_unit"] = launches / unit
    for extra in ("device_ms", "host_us", "v1_ms", "max_rel_diff_v1", "oracle_autograd_ms",
                  "function_backward_ms", "gb_max_abs_err", "kernels_per_call"):
        if extra in e:
            k[extra] = e[extra]
    if "t_flop" in e:  # the conv rows: the rate
        k["tflops"] = e["t_flop"] / e["ms"] / 1e9
        k["share_of_bound"] = e["bound_ms"] / e["ms"]
    return k


def main(argv=None) -> int:
    args = _parse(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    seconds = {}
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)

    report = _build.build_all()
    print(f"build: {sorted(report) or 'cached libraries'}", flush=True)
    ptxas = {}
    for name, r in report.items():
        print(f"  {name}: {r['seconds']:.1f} s", flush=True)
        if name.startswith(("conv3d_", "fused_", "minibatch_")):  # registers and spills
            ptxas[name] = _build.ptxas_report(r["log"])
            for row in ptxas[name]:
                print(f"    {_kernel_label(row['function'])}: {row['registers']} registers, "
                      f"spills {row['spill_stores']} B stored / {row['spill_loads']} B loaded",
                      flush=True)
        else:
            print(r["log"][-2000:], flush=True)
    hmma = tensor_core_instructions()
    ptxas["hmma_instructions"] = hmma
    print(f"tensor-core (HMMA) instructions in the SASS of the bf16 conv libraries: {hmma}",
          flush=True)
    check(all(hmma.values()), f"a bf16 conv library has no tensor-core instruction: {hmma}")
    phase_done("build")
    if args.only == "big_volume":  # this phase alone, for working on it: no result line
        detail = []
        big, big_launches, big_kernels = big_volume(detail)
        phase_done("big volume")
        rows = [kernel_row(*r) for r in big_volume_entries(big_kernels, big_launches)]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_big_volume.json").write_text(json.dumps(dict(
            card=card, big_volume=big, kernels=rows, shapes=detail, seconds=seconds),
            indent=1, default=str))
        print("big volume kernels: " + json.dumps(rows), flush=True)
        return 0

    if args.only == "engines":  # this phase alone, for working on it: no result line
        detail = []
        report, (entries, launches) = engines(detail)
        phase_done("engines")
        rows = [kernel_row(*r) for r in engine_entries(entries, launches)]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_engines.json").write_text(json.dumps(dict(
            card=card, engines=report, kernels=rows, shapes=detail, seconds=seconds),
            indent=1, default=str))
        print("engines kernels: " + json.dumps(rows), flush=True)
        return 0

    if args.only == "hpo":  # this phase alone, for working on it: no result line
        report = hpo()
        phase_done("hpo")
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_hpo.json").write_text(json.dumps(dict(
            card=card, hpo=report, seconds=seconds), indent=1, default=str))
        return 0

    if args.only == "tools":  # this phase alone, for working on it: no result line
        detail = []
        cfg = Config(**BENCH_CFG, starting_phase=PHASE, ending_phase=PHASE).finalize()
        params = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=PHASE,
                                               cfg=cfg, device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            model = ckpt.save_params(str(Path(tmp) / f"model_{PHASE}"), params, ema=params)
            tools_report = tools(detail, (set(), set()), Path(model), cfg)
        phase_done("tools")
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_tools.json").write_text(json.dumps(dict(
            card=card, tools=tools_report, shapes=detail, seconds=seconds), indent=1,
            default=str))
        return 0

    if args.only == "two_d":  # this phase alone, for working on it: no result line
        detail = []
        report, entries = two_d(detail)
        phase_done("two_d")
        rows = [kernel_row(*r) for r in two_d_entries(report, entries)]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_two_d.json").write_text(json.dumps(dict(
            card=card, two_d=report, kernels=rows, shapes=detail, seconds=seconds),
            indent=1, default=str))
        print("2-D kernels: " + json.dumps(rows), flush=True)
        return 0

    if args.only == "evidence":  # this phase alone, for working on it: no result line
        detail = []
        report, launches, kernels = evidence(detail)
        phase_done("evidence")
        rows = [kernel_row(*r) for r in evidence_entries(kernels, launches)]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_evidence.json").write_text(json.dumps(dict(
            card=card, evidence=report, kernels=rows, shapes=detail, seconds=seconds),
            indent=1, default=str))
        print("evidence kernels: " + json.dumps(rows), flush=True)
        return 0

    if args.only == "parallel":  # this phase alone, for working on it: no result line
        par_detail = []
        par, par_rows, slice_rows = parallel(detail=par_detail)
        phase_done("parallel")
        rows = [kernel_row(*r) for r in parallel_entries(*par_rows)]
        rows += [kernel_row(*r) for r in space_slice_entries(*slice_rows)]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_parallel.json").write_text(json.dumps(dict(
            card=card, parallel=par, kernels=rows, seconds=seconds), indent=1, default=str))
        print("parallel kernels: " + json.dumps(rows), flush=True)
        return 0

    if args.only == "parallel_space":  # phase 17 (d) alone, for working on it: no result line
        par_detail = []
        with tempfile.TemporaryDirectory() as tmp:
            par, (convs, launches) = parallel_space(Path(tmp), par_detail)
        phase_done("parallel (d)")
        rows = [kernel_row(*r) for r in parallel_entries(None, 0, convs, launches)[1:]]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_parallel_space.json").write_text(json.dumps(dict(
            card=card, space=par, kernels=rows, seconds=seconds), indent=1, default=str))
        print("parallel (d) kernels: " + json.dumps(rows), flush=True)
        return 0

    if args.only in ("parallel_space_levers", "parallel_space_families"):
        # phase 17 (e) or (f) alone, for working on it: no result line
        par_detail = []
        if args.only == "parallel_space_levers":
            par, *part = parallel_space_levers(par_detail)
            rows = space_slice_entries(part, None)
        else:
            par, *part = parallel_space_families(par_detail)
            rows = space_slice_entries(None, part)
        phase_done(f"parallel ({'e' if args.only.endswith('levers') else 'f'})")
        rows = [kernel_row(*r) for r in rows]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"chip_smoke_{args.only}.json").write_text(json.dumps(dict(
            card=card, space=par, kernels=rows, shapes=par_detail, seconds=seconds), indent=1,
            default=str))
        print(f"{args.only} kernels: " + json.dumps(rows), flush=True)
        return 0

    if args.only == "parallel_cards":  # one rank a card over NCCL: no result line
        cards = torch.cuda.device_count()
        check(cards > 1, f"--only parallel_cards needs two or more cards, not {cards}")
        with tempfile.TemporaryDirectory() as tmp:
            par = dict(ranks=parallel_ranks(Path(tmp), cards, one_card=False),
                       serving=parallel_serving(cards))
        # (d) over NCCL: each volume's depth over two cards (data cards / 2 x space 2)
        space, _ = _space_tool(cards - cards % 2, OUT_DIR / "profile_parallel_space_cards.json",
                               "--space", "2", "--phase", str(PHASE), device=())
        _space_checked(space["steps"], f"NCCL data {space['layout'][0]} x space 2")
        par["space"] = space
        phase_done("parallel over the cards")
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_parallel_cards.json").write_text(json.dumps(dict(
            card=card, cards=cards, parallel=par, seconds=seconds), indent=1, default=str))
        return 0

    if args.only == "families":  # this phase alone, for working on it: no result line
        detail = []
        fam, fam_launches, fam_convs = families(detail, (set(), set()))
        phase_done("families")
        rows = [kernel_row(*r) for r in family_entries(fam_convs, fam_launches)]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_families.json").write_text(json.dumps(dict(
            card=card, families=fam, kernels=rows, shapes=detail, seconds=seconds),
            indent=1, default=str))
        print("families kernels: " + json.dumps(rows), flush=True)
        return 0

    cfg = Config(**BENCH_CFG, starting_phase=PHASE, ending_phase=PHASE).finalize()
    fused_shapes, serve_convs = serving_shapes(cfg, PHASE, BATCH)
    check(len(fused_shapes) == 11 and len(serve_convs) == 6, "phase-6 serving shapes")
    detail = []
    fused = check_fused(fused_shapes, detail)
    conv = check_conv(serve_convs, detail)
    phase_done("serving kernels")

    params = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=PHASE,
                                           cfg=cfg, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        model = ckpt.save_params(str(Path(tmp) / f"model_{PHASE}"), params, ema=params)
        served = {engine: serve_engine(model, cfg, engine) for engine in ("direct", "flat")}
    for num, seed in REQUESTS:
        a, b = served["direct"][0][seed], served["flat"][0][seed]
        diff = np.abs(a - b).max()
        check(diff <= 1e-4 * np.abs(a).max(), f"engines disagree on seed {seed}: {diff}")
    print(f"direct vs flat: max|diff| {max(np.abs(served['direct'][0][s] - served['flat'][0][s]).max() for _, s in REQUESTS):.3g}",
          flush=True)
    phase_done("serving")

    # training: the flagship step under both engines from one initial state
    tcfg = bench_train_config(PHASE, BATCH)
    state0, opts = init_train_state(get_architecture("pgan"), torch.Generator().manual_seed(0),
                                    phase=PHASE, cfg=tcfg, device="cuda")
    real = real_batch(tcfg, PHASE, BATCH, "cuda")
    trained = {engine: train_engine(tcfg, engine, state0, opts, real)
               for engine in ("flat", "direct")}
    phase_done("train step")
    conv_shapes, wgrad_shapes = trained["flat"][2]
    # the conv shapes held against the plain versions so far (launch keys without their
    # dtype), which later phases skip
    checked = ({k[:-1] for k in conv_shapes}, {k[:-1] for k in wgrad_shapes})
    train_steps = TRAIN_STEPS * 2  # both halves
    train_convs = check_train_convs(conv_shapes, wgrad_shapes, train_steps, detail)
    train_fused, train_fused_grad = check_train_fused(fused_shapes, detail)
    phase_done("training kernels")
    engines_f32 = compare_engines_f32(state0, real)
    del state0, real
    phase_done("f32 engines")

    # the trainer through its CLI: phase 5 -> 6 at full width, then a preempted and
    # resumed run of the same command that must end bit-equal
    keep = tempfile.TemporaryDirectory()  # the trained checkpoint, for the tools phase
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_dataset(tmp / "data")
        trainer = run_trainer(tmp / "data", tmp / "run")
        trained_model = Path(keep.name) / f"model_{PHASE}.npz"
        shutil.copy(tmp / "run" / f"model_{PHASE}.npz", trained_model)
        trainer["python_thread"] = run_trainer_thread(tmp / "data", tmp / "thread", tmp / "run")
        phase_done("trainer")
        resume = check_bitwise_resume(tmp / "data", tmp / "resumed", tmp / "run")
        phase_done("bitwise resume")
        metrics = check_metrics(tmp / "data", params, cfg, tmp)
        phase_done("metrics")

    # kernel #3 at the serving shapes (f32; its step's shapes are the engines phase's), and
    # kernel #5 (standalone)
    zero_counts()
    v2_serving = check_conv_v2([("forward", xs, ws, 1) for xs, ws in serve_convs],
                               torch.float32, detail)
    mbstd = check_mbstd(detail)
    mbstd_launches = mb.minibatch_stddev_stat_cuda.launches
    phase_done("standalone kernels")

    # the flagship step under every other conv formulation, #3 on the flat_v2 path
    engines_report, (v2_entries, v2_launches) = engines(detail)
    for role, n in FLAT_PER_STEP.items():
        check(trained["flat"][1]["mixing"]["per_step"][role] == n,
              f"flat's #1 {role} launches a step {trained['flat'][1]['mixing']['per_step']}")
    phase_done("engines")

    # the flagship at phase 8 (128x512x512) under single_chip_big_volume: the step, its
    # kernels at the phase-8 shapes, the trainer through the CLI
    big, big_launches, big_kernels = big_volume(detail)
    phase_done("big volume")

    # the other families: surfgan at the flagship's settings (step, kernels, CLI, serving)
    # and one step of each of pgan2, pgandeep, stylegan, stylegan2
    fam, fam_launches, fam_convs = families(detail, checked)
    phase_done("families")

    # every optimizer on the flagship step, and the CLI's HPO run modes at phase 6
    hpo_report = hpo()
    phase_done("hpo")

    # the rest of tools/: test_network per family, export -> serve --artifact, the TF
    # bundle round trip, DICOM -> pyramid on the card
    tools_report = tools(detail, checked, trained_model, cfg)
    keep.cleanup()
    phase_done("tools")

    # the 2-D path: the decoder, the native prefetcher, the ProGAN-width CLI run 6 -> 7,
    # serving its phase-7 generator, #4 at every 2-D shape
    two_d_report, two_d_kernels = two_d(detail)
    phase_done("two_d")

    # the quality-evidence drivers' smoke runs: flagship, cubic, 2-D, families, HPO in
    # process, the preemption receipt in subprocesses, the gates
    evidence_report, ev_launches, ev_kernels = evidence(detail)
    phase_done("evidence")

    # data parallelism on the one card: the DP step over NCCL at world size 1, two gloo
    # ranks (the DP step, the halo conv, the CLI 5 -> 6), the row-split sampler
    par_report, par_rows, slice_rows = parallel(trained["flat"][1]["mixing"]["per_step"], detail)
    phase_done("parallel")

    main_launches = served["flat"][2]
    dispatches = served["flat"][1]["dispatches"]
    flat_runs = trained["flat"][1]
    train_launches = {k: sum(flat_runs[h]["total"][k] for h in flat_runs)
                      for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad")}
    per = (f"one phase-6 batch-8 f32 serving forward (sum over its launches); launches "
           f"counted over {dispatches} dispatches")
    per_step = (f"one phase-6 batch-8 bf16 train step under flat (sum over its launches); "
                f"launches counted over {train_steps} steps")
    per_f32 = ("one phase-6 batch-8 f32 gradient computation of the train step under flat "
               "(sum over the kernel's launches at the bf16 step's per-step counts, whose "
               "shapes it shares); launches counted over that one computation (phase 7)")
    fwd32, dgrad32 = train_convs[("forward", "float32")], train_convs[("dgrad", "float32")]
    conv32 = {k: fwd32[k] + dgrad32[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "t_bytes", "t_ops", "t_flop")}
    conv32["max_abs_err"] = max(fwd32["max_abs_err"], dgrad32["max_abs_err"])
    f32_launches = engines_f32["flat_launches"]
    per_mbstd = (f"{STANDALONE_5}; ms, device_ms and host_us summed over 8 inputs (group 4, "
                 f"N 8 and 16, the largest and smallest phase-6 D activation, f32 and bf16); "
                 f"launches of this standalone check (a ninth input of group 3 included)")
    kernels = [kernel_row(*r) for r in (
            ("fused_bias_act_pixelnorm", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:112", fused, main_launches["fused"], None, per,
             dispatches),
            ("conv3d_flat", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd.cu",
             "saragan_tpu/ops/pallas_conv.py:124", conv, main_launches["conv"], "library_ms", per,
             dispatches),
            ("fused_bias_act_pixelnorm[train,bf16]", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:112", train_fused, train_launches["fused"], None,
             per_step, train_steps),
            ("fused_bias_act_pixelnorm_grad[train,bf16]", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:123",
             train_fused_grad, train_launches["fused_grad"], None, per_step, train_steps),
            ("conv3d_flat[forward+dgrad,f32,train]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd.cu",
             "saragan_tpu/ops/pallas_conv.py:124", conv32,
             f32_launches["forward"] + f32_launches["dgrad"], "library_ms", per_f32, 1),
            ("conv3d_wgrad[f32,train]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad.cu",
             "saragan_tpu/ops/pallas_conv.py:183", train_convs[("wgrad", "float32")],
             f32_launches["wgrad"], "library_ms", per_f32, 1),
            ("conv3d_flat[forward,bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
             "saragan_tpu/ops/pallas_conv.py:124", train_convs[("forward", "bfloat16")],
             train_launches["forward"], "library_ms", per_step, train_steps),
            ("conv3d_flat[dgrad,bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
             "saragan_tpu/ops/core.py:386", train_convs[("dgrad", "bfloat16")],
             train_launches["dgrad"], "library_ms", per_step, train_steps),
            ("conv3d_wgrad[bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad_tc.cu",
             "saragan_tpu/ops/pallas_conv.py:183", train_convs[("wgrad", "bfloat16")],
             train_launches["wgrad"], "library_ms", per_step, train_steps),
            ("minibatch_stddev_stat", "cuda", MBSTD_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:159", mbstd, mbstd_launches, None, per_mbstd,
             None))]
    kernels += [kernel_row(*r) for r in engine_entries(v2_entries, v2_launches)]
    kernels += [kernel_row(*r) for r in big_volume_entries(big_kernels, big_launches)]
    kernels += [kernel_row(*r) for r in family_entries(fam_convs, fam_launches)]
    kernels += [kernel_row(*r) for r in two_d_entries(two_d_report, two_d_kernels)]
    kernels += [kernel_row(*r) for r in evidence_entries(ev_kernels, ev_launches)]
    kernels += [kernel_row(*r) for r in parallel_entries(*par_rows)]
    kernels += [kernel_row(*r) for r in space_slice_entries(*slice_rows)]
    f32_train = {f"{kind}[f32]": {x: e[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                    "max_abs_err", "launches_per_step")}
                 for (kind, dt), e in train_convs.items() if dt == "float32"}
    training = {e: dict(timing=trained[e][0], launches=trained[e][1]) for e in trained}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, shapes=detail, f32_train_kernels=f32_train, ptxas=ptxas,
        serving={e: served[e][1] for e in served}, training=training,
        engines_f32=engines_f32, engines=engines_report, v2_serving=v2_serving,
        trainer=trainer, bitwise_resume=resume, metrics=metrics,
        big_volume=big, families=fam, hpo=hpo_report, tools=tools_report, two_d=two_d_report,
        evidence=evidence_report, parallel=par_report, seconds=seconds),
        indent=1, default=str))
    print(f"serving: " + json.dumps({e: served[e][1] for e in served}), flush=True)
    print("training: " + json.dumps({e: {h: dict(step_ms=r["step_ms"], peak_mib=r["peak_mib"])
                                         for h, r in trained[e][0].items()} for e in trained}),
          flush=True)
    print("f32 training-shape kernels: " + json.dumps(f32_train), flush=True)
    print(f"f32 gradient computation under flat: {engines_f32['flat_grads_ms']:.2f} ms", flush=True)
    print("trainer: " + json.dumps(dict(
        launches=trainer["launches"], wall_s=trainer["wall_s"],
        phases={p: {k: v for k, v in r.items() if not k.endswith("_all")}
                for p, r in trainer["phases"].items()},
        python_thread_phase5_input_wait_ms=trainer["python_thread"]["input_wait_ms"])),
        flush=True)
    print("metrics: " + json.dumps({k: v for k, v in metrics.items()}), flush=True)
    print("engines: " + json.dumps(dict(
        step={n: {k: r[k] for k in ("step_ms", "peak_mib")}
              for n, r in engines_report["steps"].items()},
        f32={n: {k: r[k] for k in ("worst_grad_rel", "rerun_bit_equal", "peak_mib")}
             for n, r in engines_report["f32"].items()},
        preset={n: {k: r[k] for k in ("step_ms", "peak_mib")}
                for n, r in engines_report["preset"].items()},
        serve=engines_report["serve"], v2_serving_ms=v2_serving["ms"])), flush=True)
    print("big volume: " + json.dumps({k: big[k] for k in ("step_ms", "vol_s", "peak_mib",
                                                           "host_mib", "first_step")}),
          flush=True)
    print("families: " + json.dumps(dict(
        step={h: {k: r[k] for k in ("step_ms", "vol_s", "peak_mib")}
              for h, r in fam["step"].items()},
        trainer_wall_s=fam["trainer"]["wall_s"],
        others={n: r["launches"] for n, r in fam["others"].items()})), flush=True)
    print("hpo: " + json.dumps(dict(
        update_ms={n: r["update_ms"] for n, r in hpo_report["optimizers"].items()},
        trial_s=hpo_report["study"]["trial_s"], peak_mib=hpo_report["study"]["peak_mib"],
        study_wall_s=hpo_report["study"]["wall_s"])), flush=True)
    print("tools: " + json.dumps(dict(
        test_network_step_s={n: r["step_seconds"] for n, r in tools_report["test_network"].items()},
        artifact_forward_ms=tools_report["artifact"]["forward_ms"],
        artifact_mb=tools_report["artifact"]["mb"],
        tf_checkpoint_s=tools_report["tf_checkpoint"]["seconds"],
        crc32c_mb_s=tools_report["tf_checkpoint"]["crc32c_mb_s"],
        pyramid_s=tools_report["prepare_data"]["stages_s"])), flush=True)
    print("2-D: " + json.dumps(dict(
        decoder=two_d_report["decoder"]["name"],
        phases={p: {k: v for k, v in r.items() if not k.endswith("_all")}
                for p, r in two_d_report["trainer"]["phases"].items()},
        serve_forward_ms=two_d_report["serve"]["forward_ms"])), flush=True)
    print("evidence: " + json.dumps(dict(
        seconds=evidence_report["seconds"], launches=ev_launches,
        gates={n: g["ok"] for n, g in evidence_report["gates"].items()})), flush=True)
    tool = par_report["two_ranks"]["tool"]
    print("parallel: " + json.dumps(dict(
        nccl_world_one=dict(dp_step_ms=par_report["nccl_world_one"]["dp_step_ms"],
                            plain_step_ms=par_report["nccl_world_one"]["plain_step_ms"],
                            allreduce_ms=par_report["nccl_world_one"]["allreduce"]["ms"]),
        gloo_two_ranks={dt: dict(step_ms=r["step_ms"], allreduce_ms=r["allreduce"]["ms"])
                        for dt, r in tool["steps"].items()},
        halo=dict(halo_ms=tool["halo"]["halo_ms"], whole_ms=tool["halo"]["whole_ms"],
                  bit_equal=tool["halo"]["bit_equal"]),
        cli_wall_s=par_report["two_ranks"]["cli"]["wall_s"],
        serving_split_ms=par_report["serving"]["split_ms"])), flush=True)
    print("seconds: " + json.dumps(seconds), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _parse(argv):
    import argparse

    p = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA GPU.")
    p.add_argument("--only", choices=["engines", "big_volume", "families", "hpo", "tools",
                                       "two_d", "evidence", "parallel", "parallel_space", "parallel_space_levers",
                                       "parallel_space_families", "parallel_cards"],
                   default=None,
                   help="build, then run this phase alone (no result line)")
    return p.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main())
