"""Command-line interface of the port's trainer (own copy of ``saragan_tpu/cli.py``,
limited to the fields the port has):

    python -m saragan_tpu_torch <architecture> <dataset_path> --start_shape ... --flags

The flag names, defaults and None-able types are the reference's.  Added:
the op formulation, the reference's environment variables as flags: ``--conv_engine``
(``SARAGAN_CONV3D``: ``direct``, cuDNN; ``flat``, the hand-written kernels #1 and #2, its
``pallas``; ``flat_v2``, kernel #3, its ``pallas2``; ``gemm``, ``gemm_custom``, ``hybrid``,
``s2d``; without it the trainer takes ``flat`` on a CUDA device and ``direct`` on the CPU),
``--conv_wgrad`` (``SARAGAN_CONV3D_WGRAD``), ``--pool`` (``SARAGAN_POOL``),
``--stats_dtype`` (``SARAGAN_STATS_DTYPE``) and ``--s2d_max_cin`` (``SARAGAN_S2D_MAX_CIN``);
and ``--device`` (CUDA unless named; ``--device cpu`` trains on the CPU).  ``main`` goes through
``hpo.harness.run`` as the reference's does: one training run, or an HPO study with
``--optuna_ntrials`` / ``--optuna_walltime`` / ``--optuna_storage`` (each trial a
``Trainer`` run, scored with ``make_metrics_callback``), a best-trial replay
(``--optuna_use_best_trial``) or an inter-trial worker (``--optuna_distributed``); on a
SIGTERM or SIGINT it prints the resume hint and exits 75.  ``--single_chip_big_volume``
is the reference's preset for phases 7 and 8 on one device (``config.py``: host-offloaded
block taps, the unstacked critic, unfused transitions, the ``flat`` engine).
``--dataset imagenet`` (or a 2-D shape and a ``train/`` folder under the dataset path)
reads JPEG class folders; ``--native_prefetch`` (the default) / ``--no_native_prefetch``
pick the C++ prefetch executor or the Python thread for the npy pyramid.

``--horovod`` is data-parallel training, one process per device (the reference's
``mpirun ... --horovod``):

    torchrun --nproc_per_node N -m saragan_tpu_torch <architecture> <data> --horovod ...

``main`` joins the process group torchrun's environment describes (``nccl`` on the
cards, ``gloo`` with ``--device cpu`` and where a host's ranks share the one card
``--device`` names, which NCCL refuses) before the run, and with ``--optuna_*`` the study
runs in lockstep over the ranks.  Each rank takes ``cuda:LOCAL_RANK`` unless ``--device`` names
one.  ``--num_data_shards`` x ``--num_space_shards`` x ``--num_space2_shards`` must be the
world size (``--num_data_shards`` None: the rest): the space axes split each volume's
depth and height over the ranks (every family, with or without ``--remat`` /
``--remat_offload``).  ``--use_adasum``,
``--gpu`` and ``--num_inter_ops`` are accepted and do nothing, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json

from saragan_tpu_torch.config import Config
from saragan_tpu_torch.ops.core import CONV_ENGINES, POOLS, STATS_DTYPES, WGRAD_ENGINES


def none_or_str(value):
    return None if value == "None" else str(value)


def none_or_float(value):
    return None if value == "None" else float(value)


def none_or_int(value):
    return None if value == "None" else int(value)


def kernel_spec(value):
    with open(value) as f:
        return json.load(f)["kernel_spec"]


def filter_spec(value):
    with open(value) as f:
        return json.load(f)["filter_spec"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="saragan_tpu_torch")
    p.add_argument("architecture", type=str)
    p.add_argument("dataset_path", type=str)
    p.add_argument("--dataset", type=none_or_str, default=None,
                   help="dataset kind: None (the npy pyramid, or JPEG class folders for a "
                        "2-D shape whose dataset_path has a train/ folder) or 'imagenet'")
    p.add_argument("--start_shape", type=str, required=True,
                   help="shape of the data at phase 1, '(c, z, y, x)'")
    p.add_argument("--final_shape", type=str, required=True)
    p.add_argument("--starting_phase", type=int, required=True)
    p.add_argument("--ending_phase", type=int, required=True)
    p.add_argument("--scratch_path", type=str, default=None)
    p.add_argument("--base_batch_size", type=none_or_int, default=None)
    p.add_argument("--max_global_batch_size", type=none_or_int, default=None)
    p.add_argument("--mixing_nimg", type=int, default=2**19)
    p.add_argument("--stabilizing_nimg", type=int, default=2**19)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--horovod", default=False, action="store_true",
                   help="data-parallel training over torch.distributed, one process per "
                        "device (launch with torchrun)")
    p.add_argument("--gpu", default=False, action="store_true")  # parity no-op
    p.add_argument("--num_inter_ops", default=4, type=int)  # parity no-op
    p.add_argument("--checkpoint_every_nsteps", default=20000, type=int)
    p.add_argument("--logdir", default=None, type=str)
    p.add_argument("--continue_path", default=None, type=str)
    p.add_argument("--starting_alpha", default=1, type=float)
    p.add_argument("--validation_fraction", default=0.1, type=float)
    p.add_argument("--test_fraction", default=0.1, type=float)
    p.add_argument("--num_labels", default=None, type=none_or_int)
    # architecture
    p.add_argument("--latent_dim", type=int, required=True)
    p.add_argument("--network_size", default=None,
                   choices=["xxs", "xs", "s", "m", "l", "xl", "xxl"])
    p.add_argument("--first_conv_nfilters", type=none_or_int, default=None)
    p.add_argument("--activation", type=str, default="leaky_relu")
    p.add_argument("--leakiness", type=float, default=0.2)
    p.add_argument("--conv_kernel_size", type=none_or_int, nargs="+", default=[3, 3, 3])
    p.add_argument("--kernel_spec", type=kernel_spec, default=None)
    p.add_argument("--filter_spec", type=filter_spec, default=None)
    # learning rate
    p.add_argument("--g_lr", type=none_or_float, default=None)
    p.add_argument("--d_lr", type=none_or_float, default=None)
    for net in ("g", "d"):
        p.add_argument(f"--{net}_lr_increase", type=none_or_str,
                       choices=[None, "linear", "exponential"], default=None)
        p.add_argument(f"--{net}_lr_decrease", type=none_or_str,
                       choices=[None, "linear", "exponential"], default=None)
        p.add_argument(f"--{net}_lr_rise_niter", type=none_or_int, default=None)
        p.add_argument(f"--{net}_lr_decay_niter", type=none_or_int, default=None)
    p.add_argument("--d_scaling", default="none", choices=["linear", "sqrt", "none"])
    p.add_argument("--g_scaling", default="none", choices=["linear", "sqrt", "none"])
    # loss and optimization
    p.add_argument("--loss_fn", default="logistic", choices=["logistic", "wgan"])
    p.add_argument("--gp_weight", type=float, default=1)
    p.add_argument("--g_clipping", default=False, type=bool)
    p.add_argument("--d_clipping", default=False, type=bool)
    p.add_argument("--optim_strategy", default="simultaneous",
                   choices=["simultaneous", "alternate"])
    p.add_argument("--use_adasum", default=False, action="store_true")  # parity no-op
    p.add_argument("--ema_beta", type=float, default=0.99)
    p.add_argument("--noise_stddev", default=None, type=float, required=True)
    _optim_choices = [None, "Adam", "SGD", "Momentum", "Adadelta", "LAMB", "RAdam", "AdamW",
                      "LARS"]
    p.add_argument("--optimizer", type=none_or_str, choices=_optim_choices, default="Adam")
    p.add_argument("--d_use_different_optimizer", default=False, action="store_true")
    p.add_argument("--d_optimizer", type=none_or_str, choices=_optim_choices, default="Adam")
    p.add_argument("--weight_decay", type=float, default=0.01,
                   help="weight decay of LAMB, LARS and AdamW (not of biases, noise "
                        "strengths and spectral-norm vectors)")
    p.add_argument("--d_use_different_weight_decay", default=False, action="store_true")
    p.add_argument("--d_weight_decay", type=float, default=0.01)
    p.add_argument("--gradient_accumulation", type=int, default=1)
    p.add_argument("--use_spectral_norm", default=False, action="store_true",
                   help="spectral-normalize the discriminator's weights")
    p.add_argument("--spectral_iterations", type=int, default=3,
                   help="power iterations per forward under --use_spectral_norm")
    p.add_argument("--fused_transitions", dest="fused_transitions", default=True,
                   action="store_true", help="upscale + conv as one exact transition")
    p.add_argument("--no_fused_transitions", dest="fused_transitions", action="store_false")
    p.add_argument("--fused_grads", dest="fused_grads", default=True, action="store_true",
                   help="shared-fake-pass WGAN gradients (exact; default on)")
    p.add_argument("--no_fused_grads", dest="fused_grads", action="store_false")
    p.add_argument("--batched_passes", dest="batched_passes", default=True,
                   action="store_true", help="the fake and real critic passes as one call")
    p.add_argument("--no_batched_passes", dest="batched_passes", action="store_false")
    p.add_argument("--no_graceful_shutdown", dest="graceful_shutdown", default=True,
                   action="store_false",
                   help="disable the SIGTERM/SIGINT checkpoint-and-exit(75) handler")
    p.add_argument("--abort_on_nonfinite", default=False, action="store_true",
                   help="fail fast (with a rewind hint) when summary losses go NaN/inf")
    p.add_argument("--keep_checkpoints", type=int, default=0,
                   help="keep only the newest N cadence checkpoints per phase (0 = all)")
    p.add_argument("--auto_resume", default=False, action="store_true",
                   help="continue from the newest resume point in --logdir")
    p.add_argument("--full_state_checkpoints", default=False, action="store_true",
                   help="cadence checkpoints also save the full train state")
    p.add_argument("--gp_full_reduction", default=False, action="store_true")
    p.add_argument("--gp_grad_mode", default="revrev", choices=["revrev", "revfwd"])
    p.add_argument("--lazy_gp", default=1, type=int,
                   help="apply the gradient penalty every k-th step with k-scaled weight")
    p.add_argument("--remat", default=False, action="store_true",
                   help="recompute the G and D forwards in the backward")
    p.add_argument("--remat_offload", default=False, action="store_true",
                   help="keep only the block-boundary activations, in pinned host memory, "
                        "and recompute the rest")
    p.add_argument("--single_chip_big_volume", default=False, action="store_true",
                   help="phases 7-8 on one device: --remat_offload, --no_batched_passes, "
                        "--no_fused_transitions and the flat conv engine")
    p.add_argument("--use_pallas_fusion", default=False, action="store_true",
                   help="the fused bias + leaky ReLU + pixel norm kernel after every "
                        "generator conv (the flag keeps the reference's name)")
    p.add_argument("--adam_beta1", "--beta1", dest="adam_beta1", type=none_or_float, default=0)
    p.add_argument("--d_use_different_beta1", default=False, action="store_true")
    p.add_argument("--d_adam_beta1", type=none_or_float, default=0)
    p.add_argument("--adam_beta2", "--beta2", dest="adam_beta2", type=none_or_float,
                   default=0.9)
    p.add_argument("--d_use_different_beta2", default=False, action="store_true")
    p.add_argument("--d_adam_beta2", type=none_or_float, default=0.9)
    p.add_argument("--rho", type=none_or_float, default=0.95)
    p.add_argument("--d_use_different_rho", default=False, action="store_true")
    p.add_argument("--d_rho", type=none_or_float, default=0.95)
    p.add_argument("--momentum", type=none_or_float, default=0.9)
    p.add_argument("--d_use_different_momentum", default=False, action="store_true")
    p.add_argument("--d_momentum", type=none_or_float, default=0.9)
    p.add_argument("--g_annealing", default=1, type=float)
    p.add_argument("--d_annealing", default=1, type=float)
    # summaries
    p.add_argument("--calc_metrics", default=False, action="store_true")
    p.add_argument("--compute_metrics_train", default=False, action="store_true")
    p.add_argument("--disable_compute_metrics_validation", dest="compute_metrics_validation",
                   default=True, action="store_false")
    p.add_argument("--disable_compute_metrics_test", dest="compute_metrics_test",
                   default=True, action="store_false")
    p.add_argument("--disable_grad_histograms", dest="grad_histograms", default=True,
                   action="store_false")
    p.add_argument("--summary_small_every_nsteps", default=32, type=int)
    p.add_argument("--summary_large_every_nsteps", default=64, type=int)
    p.add_argument("--num_metric_samples", type=none_or_int, default=None)
    p.add_argument("--metrics_every_nsteps", default=128, type=int)
    p.add_argument("--metrics_batch_size", default=16, type=int)
    for m in ("FID", "swds", "ssims", "psnrs", "mses", "nrmses"):
        p.add_argument(f"--compute_{m}", default=False, action="store_true")
    p.add_argument("--inception_weights", default=None, type=none_or_str,
                   help="converted pt_inception-2015-12-05 npz for calibrated FID")
    p.add_argument("--allow_uncalibrated_fid", default=False, action="store_true",
                   help="allow random-feature FID when no Inception weights are "
                        "available (run-internal values only)")
    # HPO
    p.add_argument("--optuna_distributed", default=False, action="store_true",
                   help="inter-trial HPO: worker SARAGAN_WORKER_ID of SARAGAN_NUM_WORKERS")
    p.add_argument("--optuna_ntrials", default=None, type=none_or_int)
    p.add_argument("--hpo_seeds", default=1, type=int,
                   help="seeds per trial; > 1 reports the median objective over reseeded runs")
    p.add_argument("--optuna_walltime", default=None, type=none_or_float,
                   help="with --optuna_ntrials None, keep starting trials until this many "
                        "seconds have passed")
    p.add_argument("--optuna_use_best_trial", default=False, action="store_true")
    p.add_argument("--optuna_storage", default=None, type=str)
    p.add_argument("--optuna_study_name", default=None, type=str)
    p.add_argument("--optuna_pruner", default="median", choices=["median", "SHA", "nopruner"])
    p.add_argument("--optuna_sampler", default="TPE",
                   choices=["random", "TPE", "CMA", "NSGAII", "MOTPE"])
    p.add_argument("--optuna_warmup_steps", default=20000, type=int)
    p.add_argument("--optuna_TPE_multivariate", default=False, action="store_true")
    p.add_argument("--optuna_CMA_consider_pruned_trials", default=False, action="store_true")
    p.add_argument("--optuna_CMA_restart_strategy", default=None, type=none_or_str,
                   choices=[None, "ipop"])
    p.add_argument("--optuna_CMA_inc_popsize", default=2, type=int)
    p.add_argument("--optuna_square_kernels", default=False, action="store_true")
    # input normalization
    p.add_argument("--data_mean", default=None, type=none_or_float)
    p.add_argument("--data_stddev", default=None, type=none_or_float)
    # numerics, device
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--native_prefetch", dest="native_prefetch", default=True,
                   action="store_true",
                   help="C++ prefetch executor for the npy pyramid (default on; built with "
                        "g++ at first use)")
    p.add_argument("--no_native_prefetch", dest="native_prefetch", action="store_false",
                   help="the Python prefetch thread instead")
    p.add_argument("--transfer_dtype", default="auto",
                   choices=["auto", "float32", "float16", "bfloat16"],
                   help="host->device batch dtype; auto = bfloat16 under bfloat16 compute")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler trace of steps 5-10 of the first phase here")
    p.add_argument("--conv_engine", default="unset", choices=list(CONV_ENGINES),
                   help="the 3-D conv formulation (the JAX package's SARAGAN_CONV3D): direct "
                        "(cuDNN), flat (kernels #1 and #2, its pallas), flat_v2 (kernel #3, "
                        "its pallas2), gemm, gemm_custom, hybrid, s2d; unset: flat on a "
                        "CUDA device, direct on the CPU")
    p.add_argument("--conv_wgrad", default="library", choices=list(WGRAD_ENGINES),
                   help="the weight gradient of flat_v2 and gemm_custom "
                        "(SARAGAN_CONV3D_WGRAD; library is its xla)")
    p.add_argument("--pool", default="reshape", choices=list(POOLS),
                   help="average pooling as a reshape and mean or a windowed sum "
                        "(SARAGAN_POOL)")
    p.add_argument("--stats_dtype", default="f32", choices=list(STATS_DTYPES),
                   help="pixel norm, pooling and skinny 1x1x1 sums in f32 or in the compute "
                        "dtype (SARAGAN_STATS_DTYPE)")
    p.add_argument("--s2d_max_cin", default=16, type=int,
                   help="the most input channels s2d folds (SARAGAN_S2D_MAX_CIN)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device; CUDA unless named (e.g. 'cpu'); under --horovod "
                        "cuda:LOCAL_RANK unless named")
    # data parallelism
    p.add_argument("--num_data_shards", default=None, type=none_or_int,
                   help="the data axis under --horovod: None (the world over the space "
                        "axes) or that")
    p.add_argument("--num_space_shards", default=1, type=int,
                   help="depth shards of each volume under --horovod")
    p.add_argument("--num_space2_shards", default=1, type=int,
                   help="height shards of each volume under --horovod")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in fields})


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    from saragan_tpu_torch.hpo import harness
    from saragan_tpu_torch.train.trainer import TrainingInterrupted

    mesh = None
    if cfg.horovod:
        from saragan_tpu_torch.parallel import init_mesh

        mesh = init_mesh(args.device, num_data=cfg.num_data_shards,
                         num_space=cfg.num_space_shards, num_space2=cfg.num_space2_shards)
    try:
        return harness.run(cfg, functools.partial(harness.default_objective,
                                                  device=args.device, mesh=mesh), mesh=mesh)
    except TrainingInterrupted as e:
        # the exact-resume checkpoint is on disk; 75 (EX_TEMPFAIL) lets a wrapper requeue
        print(f"INTERRUPTED: {e}", flush=True)
        raise SystemExit(75)
    finally:
        if mesh is not None:
            mesh.close()


if __name__ == "__main__":
    main()
