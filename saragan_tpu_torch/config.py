"""Run configuration of the port: the fields the models, the train step, the trainer,
the CLI and the serving tools read.

The port keeps its own copy of ``saragan_tpu/config.py``'s ``Config`` (same field
names, defaults and derived properties), trimmed to what the port runs.  The
reference's ``apply_runtime_opts`` sets process-wide op gates; the port's counterpart,
``resolve_ops``, returns the op formulation as a value (``ops.core.Ops``: the conv
engine, the wgrad, the pool, the statistics' dtype, the widest input of ``s2d``), which
the trainer and the tools hand down to every conv, pool and pixel norm.  The fields
``conv_engine``, ``conv_wgrad``, ``pool``, ``stats_dtype`` and ``s2d_max_cin`` stand
for the reference's environment variables ``SARAGAN_CONV3D``, ``SARAGAN_CONV3D_WGRAD``,
``SARAGAN_POOL``, ``SARAGAN_STATS_DTYPE`` and ``SARAGAN_S2D_MAX_CIN``.  ``conv_engine``
left "unset" is resolved for the device (``resolve_ops``).  ``num_space_shards`` /
``num_space2_shards`` above 1 (a volume's depth and height split across the ranks of a
mesh) run for every family and engine, with or without the memory levers.
``g_annealing``, ``d_annealing`` and ``use_adasum`` are fields only, in the reference too.

``single_chip_big_volume`` is the reference's preset for phases 7 and 8 (64x256x256 and
128x512x512 volumes) on one device (``saragan_tpu/config.py:448-456``): ``finalize``
turns on ``remat_offload`` (the block-boundary activations parked in pinned host memory,
everything else recomputed) and turns off ``batched_passes`` and ``fused_transitions``;
``resolve_ops`` then picks ``flat`` on every device, as the reference's preset picks
``pallas`` (``:502-503``).  The reference's preset also sets its window pool and
statistics in the compute dtype (``saragan_tpu/ops/core.py:167-173``), layout
workarounds for the TPU's 128-lane tiles, and ``scoped_vmem_kib``, a TPU compiler
option.  The port's preset leaves ``pool`` and ``stats_dtype`` at "reshape" and "f32":
it matches the reference's preset numerically only when ``pool="window"`` and
``stats_dtype="compute"`` are passed explicitly.
"""

from __future__ import annotations

import ast
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from saragan_tpu_torch.ops import core

# the engines a Config may name: the convs' own, or "unset" for the trainer to resolve
CONV_ENGINES = ("unset", *core.CONV_ENGINES)


def _resolve_conv(engine: str, device_type: str, big_volume: bool, inference: bool) -> str:
    if engine != "unset":
        return engine
    if big_volume:
        return "flat"
    return "flat" if device_type == "cuda" and not inference else "direct"


def resolve_ops(cfg, device_type: str, inference: bool = False,
                spatial: bool = False) -> core.Ops:
    """The op formulation of `cfg` on a device of `device_type` ("cuda", "cpu", ...), the
    counterpart of the reference's ``apply_runtime_opts(spatial, inference)``
    (``saragan_tpu/config.py:460-512``).  An explicit ``conv_engine`` wins; "unset"
    resolves, as there: ``flat`` under the ``single_chip_big_volume`` preset on every
    device and for inference too (the reference's preset picks ``pallas``); otherwise
    ``direct`` for `inference` (the samplers) and on the CPU, and ``flat`` for training on
    a CUDA device, the engine measured fastest there (the reference's TPU default is
    ``s2d``, which it keeps off a sharded mesh, `spatial`, as a default only: the port's
    default is never ``s2d``, so `spatial` changes nothing here).  ``pool`` and
    ``stats_dtype`` are the config's, which the preset does not change (module
    docstring)."""
    conv = _resolve_conv(cfg.conv_engine, device_type, cfg.single_chip_big_volume, inference)
    return core.Ops(conv, cfg.conv_wgrad, cfg.pool, cfg.stats_dtype, cfg.s2d_max_cin)


def resolve_conv_engine(engine: str, device_type: str, big_volume: bool = False) -> str:
    """The trainer's conv engine name on a device of `device_type` (``resolve_ops``'s
    ``conv`` for training)."""
    return _resolve_conv(engine, device_type, big_volume, False)


def parse_tuple(value) -> Tuple[int, ...]:
    """Parse "(c, z, y, x)" strings."""
    if isinstance(value, (tuple, list)):
        return tuple(int(v) for v in value)
    return tuple(ast.literal_eval(str(value)))


def num_phases_from_shapes(start_shape, final_shape) -> int:
    """log2 of the resolution ratio."""
    start = parse_tuple(start_shape)
    final = parse_tuple(final_shape)
    return int(math.log2(final[-1] / start[-1]))


def default_filter_spec(num_phases: int, base_shape, size: str = "xs", ndim: int = 3) -> list:
    """Filter spec derived from the num_filters tables."""
    from saragan_tpu_torch.ops.core import num_filters, num_filters_2d

    spec = []
    for phase in range(1, num_phases + 1):
        if ndim == 3:
            f = num_filters(phase, num_phases, base_shape, size=size)
        else:
            f = num_filters_2d(phase, num_phases, size=size)
        spec.append([int(f), int(f)])
    return spec


@dataclass
class Config:
    architecture: str = "pgan"
    dataset_path: str = ""
    # dataset kind: None = the npy pyramid, or for a 2-D config whose dataset_path holds
    # a train/ folder the JPEG class folders; "imagenet" = the JPEG class folders
    dataset: Optional[str] = None
    start_shape: str = "(1, 4, 4, 4)"
    final_shape: str = "(1, 32, 32, 32)"
    starting_phase: int = 1
    ending_phase: Optional[int] = None
    scratch_path: Optional[str] = None
    max_global_batch_size: Optional[int] = None
    mixing_nimg: int = 2**19
    stabilizing_nimg: int = 2**19
    seed: int = 42
    # data parallelism: one process per device over torch.distributed (parallel/); the
    # CLI joins the process group (torchrun's environment) before the run
    horovod: bool = False
    checkpoint_every_nsteps: int = 20000
    logdir: Optional[str] = None
    continue_path: Optional[str] = None
    starting_alpha: float = 1.0
    validation_fraction: float = 0.1
    test_fraction: float = 0.1
    # surfgan's projection conditioning: the mapping's conditioning weight when set (the
    # trainer feeds no labels, as the reference's does not)
    num_labels: Optional[int] = None
    latent_dim: int = 256
    # filters of the first layer of the num_filters-table families (None: the table's)
    first_conv_nfilters: Optional[int] = None
    network_size: Optional[str] = "xs"
    activation: str = "leaky_relu"
    leakiness: float = 0.2
    conv_kernel_size: Sequence[int] = (3, 3, 3)
    kernel_spec: Optional[list] = None
    filter_spec: Optional[list] = None
    data_mean: Optional[float] = None
    data_stddev: Optional[float] = None
    # fused bias + leaky ReLU + pixel norm kernel after every generator conv
    use_pallas_fusion: bool = False
    # upscale + conv_1 of each generator block as one transposed conv (exact)
    fused_transitions: bool = True
    # --- training (saragan_tpu/config.py:75,98-141,195,212-274) ---
    base_batch_size: Optional[int] = None
    g_lr: Optional[float] = 1e-3
    d_lr: Optional[float] = 1e-3
    g_lr_increase: Optional[str] = None
    g_lr_decrease: Optional[str] = None
    d_lr_increase: Optional[str] = None
    d_lr_decrease: Optional[str] = None
    g_lr_rise_niter: Optional[int] = None
    g_lr_decay_niter: Optional[int] = None
    d_lr_rise_niter: Optional[int] = None
    d_lr_decay_niter: Optional[int] = None
    d_scaling: str = "none"
    g_scaling: str = "none"
    loss_fn: str = "logistic"
    gp_weight: float = 1.0
    use_spectral_norm: bool = False  # spectral-normalize the discriminator's weights
    spectral_iterations: int = 3  # power iterations per forward from the persisted u
    g_clipping: bool = False
    d_clipping: bool = False
    optim_strategy: str = "simultaneous"
    use_adasum: bool = False  # a field only, in the reference too
    ema_beta: float = 0.99
    noise_stddev: float = 0.0
    optimizer: Optional[str] = "Adam"
    d_use_different_optimizer: bool = False
    d_optimizer: Optional[str] = "Adam"
    adam_beta1: Optional[float] = 0.0
    d_use_different_beta1: bool = False
    d_adam_beta1: Optional[float] = 0.0
    adam_beta2: Optional[float] = 0.9
    d_use_different_beta2: bool = False
    d_adam_beta2: Optional[float] = 0.9
    rho: Optional[float] = 0.95  # Adadelta
    d_use_different_rho: bool = False
    d_rho: Optional[float] = 0.95
    momentum: Optional[float] = 0.9  # Momentum, LARS
    d_use_different_momentum: bool = False
    d_momentum: Optional[float] = 0.9
    weight_decay: float = 0.01  # LAMB, LARS, AdamW (the decayed names only)
    d_use_different_weight_decay: bool = False
    d_weight_decay: float = 0.01
    g_annealing: float = 1.0
    d_annealing: float = 1.0
    gradient_accumulation: int = 1
    compute_dtype: str = "float32"  # "bfloat16": bf16 activations, f32 params and state
    # the mesh: data x space x space2 is the world (one process per device), data None
    # the rest; the spatial axes split a volume's depth and height across the ranks
    num_data_shards: Optional[int] = None
    num_space_shards: int = 1
    num_space2_shards: int = 1
    remat: bool = False
    remat_offload: bool = False
    lazy_gp: int = 1  # GP every k-th step with k-scaled weight (1 = every step)
    # reduce the GP norm over all non-batch axes instead of the reference's (1, 2, 3)
    gp_full_reduction: bool = False
    # shared-fake-pass WGAN gradients: one D backward over the fake batch instead of two
    fused_grads: bool = True
    # algebra of the penalty's parameter gradient: 'revrev' (reverse over reverse) or
    # 'revfwd' (the gradient of a directional derivative along the penalty's cotangent)
    gp_grad_mode: str = "revrev"
    # fake and real critic passes as one D call over both batches
    batched_passes: bool = True
    # --- trainer (saragan_tpu/config.py:145-153,203-250) ---
    calc_metrics: bool = False  # the metric pass every metrics_every_nsteps and per phase
    compute_metrics_train: bool = False  # end-of-phase metrics on the train split
    compute_metrics_validation: bool = True
    compute_metrics_test: bool = True
    grad_histograms: bool = True  # per-variable gradient histograms on summary steps
    summary_small_every_nsteps: int = 32
    summary_large_every_nsteps: int = 64
    num_metric_samples: Optional[int] = None  # None: one batch of the phase
    metrics_every_nsteps: int = 128
    metrics_batch_size: int = 16
    compute_FID: bool = False
    inception_weights: Optional[str] = None  # converted pt_inception npz (metrics/inception)
    allow_uncalibrated_fid: bool = False  # opt in to random-feature FID (run-internal only)
    compute_swds: bool = False
    compute_ssims: bool = False
    compute_psnrs: bool = False
    compute_mses: bool = False
    compute_nrmses: bool = False
    # --- HPO (saragan_tpu/config.py:219-245; hpo/harness.py) ---
    optuna_distributed: bool = False  # inter-trial: workers share one study
    optuna_ntrials: Optional[int] = None
    hpo_seeds: int = 1  # seeds per trial; > 1 reports the median objective
    optuna_walltime: Optional[float] = None  # with ntrials None: start trials until then
    optuna_use_best_trial: bool = False
    optuna_storage: Optional[str] = None
    optuna_study_name: Optional[str] = None
    optuna_pruner: str = "median"
    optuna_sampler: str = "TPE"
    optuna_warmup_steps: int = 20000
    optuna_TPE_multivariate: bool = False
    optuna_CMA_consider_pruned_trials: bool = False
    optuna_CMA_restart_strategy: Optional[str] = None
    optuna_CMA_inc_popsize: int = 2
    optuna_square_kernels: bool = False
    # host->device batch dtype; "auto" = bfloat16 under bfloat16 compute, else float32
    transfer_dtype: str = "auto"
    # the C++ prefetch executor for path-based datasets (data/native.py); off: the
    # Python prefetch thread
    native_prefetch: bool = True
    profile_dir: Optional[str] = None  # torch.profiler trace of steps 5-10 of the first phase
    full_state_checkpoints: bool = False  # cadence checkpoints also save the full state
    graceful_shutdown: bool = True  # SIGTERM/SIGINT: finish the step, checkpoint, exit 75
    auto_resume: bool = False  # continue from the newest resume point in the logdir
    keep_checkpoints: int = 0  # newest N cadence checkpoints per phase (0 = all)
    abort_on_nonfinite: bool = False  # raise TrainingDiverged on a non-finite summary loss
    # phases 7-8 on one device: remat_offload, unstacked critic, unfused transitions, flat
    single_chip_big_volume: bool = False
    # the op formulation (ops.core.Ops; resolve_ops): the conv engine, one of
    # ops.core.CONV_ENGINES (SARAGAN_CONV3D), "unset" for the trainer to pick one for its
    # device; the wgrad of flat_v2 and gemm_custom, "library" or "einsum"
    # (SARAGAN_CONV3D_WGRAD, "library" being its "xla"); the pool, "reshape" or "window"
    # (SARAGAN_POOL); the statistics' dtype, "f32" or "compute" (SARAGAN_STATS_DTYPE);
    # the widest input s2d folds (SARAGAN_S2D_MAX_CIN)
    conv_engine: str = "unset"
    conv_wgrad: str = "library"
    pool: str = "reshape"
    stats_dtype: str = "f32"
    s2d_max_cin: int = 16

    @property
    def start_shape_t(self) -> Tuple[int, ...]:
        return parse_tuple(self.start_shape)

    @property
    def base_shape(self) -> Tuple[int, ...]:
        """(channels, *spatial) at phase 1."""
        return self.start_shape_t

    @property
    def ndim(self) -> int:
        """Spatial rank: 3 for volumes, 2 for images."""
        return len(self.start_shape_t) - 1

    @property
    def num_phases(self) -> int:
        return num_phases_from_shapes(self.start_shape, self.final_shape)

    def current_shape(self, phase: int, batch_size: int) -> Tuple[int, ...]:
        s = self.start_shape_t
        return (batch_size, s[0], *[d * 2 ** (phase - 1) for d in s[1:]])

    def batch_size_for_phase(self, phase: int, global_size: int = 1) -> int:
        """Per-worker batch size: halved each phase, capped at
        max_global_batch_size / global_size in every phase."""
        assert self.base_batch_size is not None
        batch_size = max(1, self.base_batch_size // (2 ** (phase - 1)))
        if self.max_global_batch_size is not None:
            batch_size = min(batch_size, max(1, self.max_global_batch_size // global_size))
        return batch_size

    def resolved_kernel_spec(self) -> list:
        """Kernel spec from conv_kernel_size, shrunk per phase so a kernel never exceeds
        the phase's spatial dims (largest odd size that fits)."""
        if self.kernel_spec is not None:
            return self.kernel_spec
        from saragan_tpu_torch.ops.core import get_kernel

        k = list(self.conv_kernel_size)[: self.ndim]
        if len(k) < self.ndim:
            k = k + [k[-1]] * (self.ndim - len(k))
        spec = []
        for phase in range(1, self.num_phases + 1):
            spatial = [d * 2 ** (phase - 1) for d in self.base_shape[1:]]
            kk = get_kernel(spatial, k)
            spec.append([([] if phase == 1 else list(kk)), list(kk)])
        return spec

    def resolved_filter_spec(self) -> list:
        if self.filter_spec is not None:
            return self.filter_spec
        size = self.network_size or "xs"
        return default_filter_spec(self.num_phases, self.base_shape, size=size, ndim=self.ndim)

    def finalize(self) -> "Config":
        """Derived defaults (the transfer dtype, the LR rise/decay lengths from the phase
        halves, D's optimizer settings mirroring G's unless d_use_different_*), the
        phase-range checks of the reference's finalize and its one-phase rule for
        stylegan2."""
        c = dataclasses.replace(self)
        if c.transfer_dtype == "auto":
            c.transfer_dtype = "bfloat16" if c.compute_dtype == "bfloat16" else "float32"
        if c.g_lr_rise_niter is None:
            c.g_lr_rise_niter = c.mixing_nimg // 2
        if c.g_lr_decay_niter is None:
            c.g_lr_decay_niter = c.stabilizing_nimg // 2
        if c.d_lr_rise_niter is None:
            c.d_lr_rise_niter = c.mixing_nimg // 2
        if c.d_lr_decay_niter is None:
            c.d_lr_decay_niter = c.stabilizing_nimg // 2
        if c.conv_engine not in CONV_ENGINES:
            raise ValueError(f"conv_engine must be one of {CONV_ENGINES}; got {c.conv_engine!r}")
        core.Ops(wgrad=c.conv_wgrad, pool=c.pool, stats=c.stats_dtype,
                 s2d_max_cin=c.s2d_max_cin)  # raises ValueError on a bad choice
        if not c.d_use_different_optimizer:
            c.d_optimizer = c.optimizer
        if not c.d_use_different_beta1:
            c.d_adam_beta1 = c.adam_beta1
        if not c.d_use_different_beta2:
            c.d_adam_beta2 = c.adam_beta2
        if not c.d_use_different_rho:
            c.d_rho = c.rho
        if not c.d_use_different_momentum:
            c.d_momentum = c.momentum
        if not c.d_use_different_weight_decay:
            c.d_weight_decay = c.weight_decay
        if c.ending_phase is None:
            c.ending_phase = c.num_phases
        if c.architecture == "stylegan2" and c.starting_phase != c.ending_phase:
            # the reference's main.py:413-414: stylegan2 has no progressive growing
            raise ValueError("stylegan2 does not support progressive growing; "
                             "starting_phase must equal ending_phase")
        if c.starting_phase > c.num_phases:
            raise ValueError(
                f"starting_phase={c.starting_phase} exceeds num_phases={c.num_phases} "
                f"(= log2(final/start) from start_shape={c.start_shape}, "
                f"final_shape={c.final_shape})")
        if c.ending_phase and c.ending_phase > c.num_phases:
            raise ValueError(
                f"ending_phase={c.ending_phase} exceeds num_phases={c.num_phases} "
                f"(= log2(final/start) from start_shape={c.start_shape}, "
                f"final_shape={c.final_shape})")
        if c.single_chip_big_volume:
            c.remat_offload = True
            c.batched_passes = False
            c.fused_transitions = False
        return c
