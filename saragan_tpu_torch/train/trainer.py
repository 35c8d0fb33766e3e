"""The phase loop (counterpart of ``saragan_tpu/train/trainer.py``): one ``Trainer.run``
is a whole multi-phase progressive-growing run.  Per phase:

* the phase's dataset and its ordered train / validation / test split;
* the phase's batch size (halved each phase, globally capped);
* the phase's parameters from the seeded init, restored by name from the previous
  phase's ``model_<phase-1>.npz`` (or from ``continue_path`` in the first phase; new
  layers keep their init, the EMA restarts from the restored weights), or the whole
  state from a full-state file for an exact mid-phase resume;
* the mixing half with the previous phase's names frozen and alpha fading to 0, then the
  stabilizing half at a static alpha of 0; the ``lazy_gp`` no-penalty variants; the
  histogram variants on summary steps; the LR schedule;
* cadence checkpoints (with the full state when asked), summaries with validation
  losses under the training weights and under the EMA, throughput windows closed by a
  device sync at summary steps only;
* the phase-final ``model_<phase>.npz`` with the EMA folded into the weights.

Preemption: SIGTERM/SIGINT let the running step finish, write an exact-resume
``_interrupt.pkl`` and raise ``TrainingInterrupted`` (the CLI exits 75); ``auto_resume``
picks the newest resume point up.  Random draws do not depend on a resume: the draws of
step ``local_step`` of phase p come from a fresh ``torch.Generator`` on the device,
seeded from the pair (seed + 1000 p, 2 local_step) as the reference folds
``fold_in(PRNGKey(seed + 1000 p), 2 local_step)``; summary draws use 2 local_step + 1.
The numbers are torch's, not JAX's; tests hand the reference's draws in through
``draws_fn``.  With the full-state restore of counters and optimizer slots and
``NumpyPathDataset.fast_forward``, a preempted and resumed run ends bit-identical to an
uninterrupted one where every kernel on the path is deterministic.

On a CUDA device each step is bracketed by CUDA events (no sync); at the end of a phase
their times go to ``events.jsonl`` as ``Timing/step_ms_mixing`` and
``Timing/step_ms_stabilizing``, with the phase's peak device memory
(``memory/phase_peak_bytes``).

Metrics (``calc_metrics`` with a ``metrics_callback``, e.g.
``metrics.save_metrics.make_metrics_callback``): every ``metrics_every_nsteps`` under the
training weights and under the EMA (suffix ``_EMA``), and at the end of each phase under
the EMA on the test, validation and train splits (``_test``, ``_validation``,
``_train``); the validation FID becomes ``last_fid``.  A metric pass stays out of the
throughput window; its host seconds go to ``events.jsonl`` as ``Timing/metrics_s``.  The
fakes come from ``sampler(generator, n)``: z drawn from the given ``torch.Generator`` in
the compute dtype, the generator run on the trainer's device and engine.

``profile_dir``: a ``torch.profiler`` trace (host, and the card's kernels on a CUDA
device) of steps 5 to 10 of the starting phase, written there as a Chrome trace
(``trace_phase<p>_steps5-10.json``; cut at the phase's end if it has fewer steps, none if
it ends before step 5).

HPO: a ``trial`` (the engine's or Optuna's, with ``report(value, step)`` and
``should_prune()``) gets each calibrated FID of the metric pass under the training
weights; when it asks to prune past ``optuna_warmup_steps`` images into the phase the run
raises ``TrialPruned``.  An uncalibrated (random-feature) FID is never reported.

Data: the npy pyramid, or for ``dataset="imagenet"`` (or a 2-D config whose
``dataset_path`` holds a ``train/`` folder) the JPEG class folders of
``data/imagenet.py`` with ``max(1, num_labels)`` classes, by the reference's rule.  Input
pipeline, by the reference's rule too: the C++ prefetch executor (``data/native.py``)
when ``native_prefetch`` is on, ``data_mean`` / ``data_stddev`` are both set or both
unset and the dataset is path-based (the npy pyramid); else the Python prefetch thread.
The log and ``events.jsonl`` (``config/input_pipeline``) say which ran, and each phase
writes the host's mean wait for its next batch (``Timing/input_wait_ms``, the first step
left out).

Data parallelism (``mesh``, a ``parallel.Mesh``: one process per device, as the
reference's mesh over its 'data' axis): the global size is the world size, the phase's
batch size is each rank's and the global batch their sum; the learning rates scale with
the world size as ``g_scaling`` / ``d_scaling`` ask (``scale_lr``); every rank draws the same global path list and loads its
paths [rank::world] (``batch_sharded`` on the Python thread, the same slice on the C++
prefetcher), so each volume is read once per global batch; the parameters come from
rank 0 at each phase's start (``parallel.broadcast_params_``); the step averages its
gradients and losses over the ranks and ``draws_fn`` returns the global batch's draws,
of which the step takes each rank's rows.  Every rank writes the same checkpoints (under
per-process temporary names) and ends with bit-identical parameters; rank 0 alone prints
and writes ``events.jsonl``; img/s is global, ``local_img_s`` per rank.  A signal stops
every rank after the same step: whether one arrived on any rank is agreed after each step
(``parallel.any_rank``), so no rank is left in a collective.  The validation losses of the
summaries run on rank 0's batch alone.  ``num_space_shards`` / ``num_space2_shards``
above 1 raise ``NotImplementedError`` (ROADMAP.md queue 1 item 16).
"""

from __future__ import annotations

import hashlib
import os
import re
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from saragan_tpu_torch import losses
from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.config import Config, resolve_conv_engine
from saragan_tpu_torch.data import NumpyPathDataset, Prefetcher, get_numpy_dataset, normalize_numpy
from saragan_tpu_torch.data.native import NativeBatchPrefetcher
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops.core import LayerNoise, generator_seed
from saragan_tpu_torch.optim.ema import fold_ema
from saragan_tpu_torch.optim.freeze import apply_freeze_names
from saragan_tpu_torch.optim.schedules import lr_schedule, scale_lr
from saragan_tpu_torch.parallel import (SPACE_NOT_PORTED, any_rank, broadcast_params_, rank,
                                        world_size)
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train import summaries as summ
from saragan_tpu_torch.train.step import (TrainState, _train_numerics, compute_dtype,
                                          init_train_state, make_train_step, model_fns,
                                          split_params, style_phase)

_TRANSFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                    "float16": torch.float16}


def resolve_transfer_dtype(cfg) -> torch.dtype:
    """The host->device batch dtype: "auto" is bfloat16 under bfloat16 compute (exact:
    the step's first op casts the batch to the compute dtype, and torch rounds f32 to
    bf16 to nearest even on the host as on the device), else float32."""
    td = cfg.transfer_dtype
    if td == "auto":
        td = "bfloat16" if cfg.compute_dtype == "bfloat16" else "float32"
    return _TRANSFER_DTYPES[td]


def step_generator(base: int, salt: int, device) -> torch.Generator:
    """A fresh generator on `device` for the pair (base, salt): the counterpart of
    ``fold_in(PRNGKey(base), salt)``, the same for a resumed run as for an
    uninterrupted one."""
    digest = hashlib.sha256(f"{base}/{salt}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


class TrialPruned(Exception):
    """Raised to prune an HPO trial (mirrors optuna.TrialPruned)."""


class TrainingDiverged(Exception):
    """A summary-step loss came back non-finite and ``abort_on_nonfinite`` is set.  The
    message names the last checkpoint a later summary confirmed finite."""

    def __init__(self, phase: int, global_step: int, d_loss, g_loss,
                 last_checkpoint: Optional[str], checkpoint_phase: Optional[int] = None):
        hint = (f"rewind with --continue_path {last_checkpoint}"
                + (f" --starting_phase {checkpoint_phase}" if checkpoint_phase is not None
                   else "")
                if last_checkpoint else "no checkpoint written yet")
        super().__init__(f"non-finite losses at phase {phase} step {global_step} "
                         f"(d_loss={d_loss}, g_loss={g_loss}); {hint}")
        self.phase = phase
        self.global_step = global_step
        self.last_checkpoint = last_checkpoint
        self.checkpoint_phase = checkpoint_phase


class TrainingInterrupted(Exception):
    """A SIGTERM/SIGINT arrived: the running step finished and an exact-resume
    full-state checkpoint was written; ``resume_path`` goes back as --continue_path."""

    def __init__(self, resume_path: str, phase: int, global_step: int):
        super().__init__(f"training interrupted at phase {phase} step {global_step}; "
                         f"resume with --continue_path {resume_path} "
                         f"--starting_phase {phase}")
        self.resume_path = resume_path
        self.phase = phase
        self.global_step = global_step


@dataclass
class PhaseResult:
    phase: int
    global_step: int
    last_fid: Optional[float]
    img_s: float


def _sampler(sample, g_params, alpha: float):
    """The metrics callback's sampler(generator, n) of `g_params` at `alpha`."""
    return lambda generator, n: sample(g_params, generator, n, alpha)


class _OnDevice:
    """A host-batch prefetcher whose batches go to `device` as they are taken (from
    pinned memory without blocking the host on a CUDA device)."""

    def __init__(self, host, device: torch.device):
        self._host = host
        self._device = device

    def __next__(self) -> torch.Tensor:
        return next(self._host).to(self._device, non_blocking=self._device.type == "cuda")

    def stop(self):
        self._host.stop()


class Trainer:
    def __init__(self, cfg: Config, *, mesh=None,
                 dataset_factory: Optional[Callable[[int], NumpyPathDataset]] = None,
                 metrics_callback: Optional[Callable] = None, trial=None,
                 verbose: bool = True, prefetch: bool = True, device=None,
                 draws_fn: Optional[Callable[[int, int], losses.Draws]] = None):
        """dataset_factory(phase) -> dataset overrides the npy pyramid (tests).
        draws_fn(phase, local_step) -> losses.Draws hands every step its random inputs
        (tests feed the reference's draws); None draws them on the device.
        trial: an HPO trial with ``report(value, step)`` and ``should_prune()``.
        `device` is CUDA unless named; with a `mesh` (``parallel.Mesh``) the mesh's."""
        if cfg.num_space_shards > 1 or cfg.num_space2_shards > 1:
            raise NotImplementedError(SPACE_NOT_PORTED)
        if mesh is not None and device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # the run's engine, resolved for the device where unset: what the steps, the
        # events and a resumed run (which resolves the same way) see.  Held here, not
        # written into the caller's config, so that another Trainer built from the same
        # config resolves its own
        self.conv_engine = resolve_conv_engine(cfg.conv_engine, self.device.type,
                                               cfg.single_chip_big_volume)
        self.arch = get_architecture(cfg.architecture)
        self.dataset_factory = dataset_factory
        self.draws_fn = draws_fn
        self.metrics_callback = metrics_callback
        self.trial = trial
        self.global_size = world_size(mesh)
        self.verbose = verbose and (mesh is None or mesh.rank == 0)
        self.prefetch = prefetch
        self.logdir = cfg.logdir or os.path.join("runs", cfg.architecture,
                                                 time.strftime("%Y-%m-%d_%H-%M-%S"))
        self._already_complete = False
        self._auto_resume_note: Optional[str] = None
        if cfg.auto_resume and not cfg.continue_path:
            ar = ckpt.find_auto_resume(self.logdir, cfg.ending_phase or cfg.num_phases)
            if ar is not None and ar.complete:
                self._already_complete = True
            elif ar is not None:
                cfg.continue_path = ar.continue_path
                cfg.starting_phase = ar.starting_phase
                self._auto_resume_note = (f"auto_resume: continuing from {ar.continue_path} "
                                          f"at phase {ar.starting_phase}")
        self.writer = summ.SummaryWriter(self.logdir if self.verbose else None)
        self.writer.text("config/conv_engine", self.conv_engine, 0)
        self.last_fid: Optional[float] = None
        self.last_img_s: float = 0.0
        self.state: Optional[TrainState] = None
        self.phase: Optional[int] = None
        self._interrupt: Optional[int] = None  # signal number, set by the handler
        self._last_checkpoint: Optional[str] = None
        self._last_checkpoint_phase: Optional[int] = None
        # the last checkpoint a LATER summary confirmed finite: the divergence hint
        self._last_finite_checkpoint: Optional[str] = None
        self._last_finite_checkpoint_phase: Optional[int] = None
        self._installed_handlers: dict = {}
        # a full-state resume keeps global_step on the original run's numbering (file
        # names stay monotone across requeues); this offset reconciles it with this
        # run's starting_phase-relative schedule
        self._step_offset = 0
        # the _interrupt.pkl a restore consumed, deleted once a newer full state lands
        self._consumed_interrupt: Optional[str] = None

    # ------------------------------------------------------------------

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _get_dataset(self, phase: int) -> NumpyPathDataset:
        if self.dataset_factory is not None:
            return self.dataset_factory(phase)
        cfg = self.cfg
        if cfg.dataset == "imagenet" or (
                cfg.dataset is None and cfg.ndim == 2
                and os.path.isdir(os.path.join(cfg.dataset_path or "", "train"))):
            # the 2-D JPEG class folders, resized per phase; the factory is kept so the
            # listing and the scratch copy happen once across phases
            from saragan_tpu_torch.data.imagenet import decoder_name, imagenet_dataset_factory

            self.dataset_factory = imagenet_dataset_factory(
                cfg, cfg.dataset_path, num_classes=max(1, cfg.num_labels or 1))
            ds = self.dataset_factory(phase)
            self._log(f"JPEG decoder: {decoder_name(ds.decoder)}")
            return ds
        return get_numpy_dataset(phase, cfg.starting_phase, cfg.start_shape, cfg.dataset_path,
                                 cfg.scratch_path, verbose=self.verbose,
                                 copy_files=cfg.scratch_path is not None, seed=cfg.seed)

    def _restore_for_phase(self, phase: int, state: TrainState) -> TrainState:
        """Phase chaining / continue_path: weights restored by name intersection,
        counters reset, the EMA reseeded from the restored weights; a ``.pkl`` path
        restores the whole state, optimizer slots and counters included."""
        cfg = self.cfg
        restore_path = None
        if phase > cfg.starting_phase:
            restore_path = ckpt.phase_checkpoint_path(self.logdir, phase - 1)
        elif cfg.continue_path and phase == cfg.starting_phase:
            restore_path = cfg.continue_path
        if restore_path is None:
            self._log("Not restoring variables.")
            return state

        if restore_path.endswith(".pkl"):
            self._log(f"Restoring FULL train state (incl. optimizer) from: {restore_path}")
            full_state, counters = ckpt.load_full_state(restore_path, self.device)
            assert set(full_state.g_params) == set(state.g_params), (
                "full-state checkpoint is for a different phase/architecture")
            self._resume_counters = counters
            if restore_path.endswith("_interrupt.pkl"):
                self._consumed_interrupt = restore_path
            npz_twin = re.sub(r"(_interrupt|_full)\.pkl$", ".npz", restore_path)
            self._seed_finite_checkpoint(
                npz_twin if os.path.exists(npz_twin) else restore_path, phase)
            return full_state

        self._log(f"Restoring variables from: {restore_path}")
        saved_params, _ema, _meta = ckpt.load_params(restore_path, self.device)
        self._seed_finite_checkpoint(
            restore_path if restore_path.endswith(".npz") else restore_path + ".npz", phase)
        restored = ckpt.restore_into({**state.g_params, **state.d_params}, saved_params)
        g_params, d_params = split_params(restored)
        ema = {k: v.detach().clone() for k, v in restored.items()}
        return state._replace(g_params=g_params, d_params=d_params, ema=ema)

    def _prev_phase_names(self, phase: int, params: dict) -> frozenset:
        if phase <= 1:
            return frozenset()
        prev = self.arch.init(torch.Generator().manual_seed(self.cfg.seed), phase=phase - 1,
                              cfg=self.cfg, device="meta")
        return apply_freeze_names(params, prev)

    def _handle_signal(self, signum, frame):
        """First SIGTERM/SIGINT: finish the running step, checkpoint, exit.  The previous
        handlers come back at once, so a second signal takes its normal effect."""
        self._interrupt = signum
        for s, prev in self._installed_handlers.items():
            signal.signal(s, prev)
        self._installed_handlers = {}
        # os.write is async-signal-safe; print() is not
        os.write(2, (f"Received signal {signum}: finishing the in-flight step, then writing "
                     f"an exact-resume checkpoint and exiting (send again to terminate "
                     f"immediately)\n").encode())

    def _seed_finite_checkpoint(self, path: str, phase: int):
        """Seed the divergence hint and the prune protection from a resume point (the
        phase it restores into)."""
        self._last_finite_checkpoint = path
        self._last_finite_checkpoint_phase = phase
        self._last_checkpoint = path
        self._last_checkpoint_phase = phase

    def _supersede_consumed_interrupt(self):
        """A newer full state landed: the consumed _interrupt.pkl goes."""
        if self._consumed_interrupt:
            try:
                os.remove(self._consumed_interrupt)
            except OSError:
                pass
            self._consumed_interrupt = None

    def _save_phase_checkpoint(self, phase: int, state: TrainState, global_step: int,
                               step: Optional[int] = None):
        path = ckpt.phase_checkpoint_path(self.logdir, phase, step)
        ckpt.save_params(path, {**state.g_params, **state.d_params}, ema=state.ema,
                         meta={"global_step": global_step, "phase": phase})
        self._last_checkpoint = path + ".npz"
        self._last_checkpoint_phase = phase
        self._log(f"Writing checkpoint file: {os.path.basename(path)}")
        if step is not None and self.cfg.keep_checkpoints > 0:
            ckpt.prune_cadence_checkpoints(self.logdir, phase, self.cfg.keep_checkpoints,
                                           protect={self._last_finite_checkpoint})

    def _make_eval_losses(self, phase: int):
        """Loss evaluation without parameter gradients: (gen, disc, gp, gen_sample)."""
        cfg, arch, dtype = self.cfg, self.arch, compute_dtype(self.cfg)

        def eval_losses(g_params, d_params, real, gen, alpha):
            a = torch.tensor(float(alpha))
            real = real.to(dtype)
            draws = losses.draw_inputs(gen, real.shape[0], cfg.latent_dim, real.shape[1:],
                                       dtype, real.device, noise_stddev=cfg.noise_stddev,
                                       style_phase=style_phase(arch, phase))
            gen_fn, disc_fn, gp_disc_fn = model_fns(arch, cfg, phase, a, self.conv_engine,
                                                    draws)
            with _train_numerics():
                out = losses.forward_simultaneous(
                    gen_fn, disc_fn, g_params, d_params, real, draws, loss_fn=cfg.loss_fn,
                    gp_weight=cfg.gp_weight, noise_stddev=cfg.noise_stddev,
                    gp_disc_fn=gp_disc_fn)
            return tuple(v.detach() for v in out)

        return eval_losses

    def _make_sample_fn(self, phase: int):
        """sample(g_params, generator, n, alpha) -> (n, C, ...) f32 numpy: z drawn from
        `generator` (on its own device) in the compute dtype, the generator run in
        sampling mode (``train=False``, a style family's noise seeded from `generator`)
        on the trainer's device and engine without a graph."""
        cfg, arch, dtype = self.cfg, self.arch, compute_dtype(self.cfg)

        def sample(g_params, generator: torch.Generator, n: int, alpha: float) -> np.ndarray:
            z = torch.randn((n, cfg.latent_dim), generator=generator, device=generator.device)
            with torch.inference_mode(), _train_numerics():
                out = arch.generator(g_params, z.to(self.device, dtype),
                                     torch.tensor(float(alpha)), phase=phase, cfg=cfg,
                                     conv_engine=self.conv_engine, train=False,
                                     noise=LayerNoise(generator_seed(generator)))
            return out.float().cpu().numpy()

        return sample

    def _run_metrics(self, state: TrainState, npy_val, sample, global_step: int,
                     in_phase_step: int, alpha: float):
        """The metric pass under the training weights, then under the EMA (``_EMA``);
        the first's FID goes to the HPO trial, if calibrated, which may prune the run."""
        m = self.metrics_callback(self, _sampler(sample, state.g_params, alpha), npy_val,
                                  global_step, "")
        self.metrics_callback(self, _sampler(sample, split_params(state.ema)[0], alpha),
                              npy_val, global_step, "_EMA")
        fid = (m or {}).get("FID")
        if fid is not None:
            self.last_fid = float(fid)
        # never feed an uncalibrated (random-feature) FID to the pruner: callbacks built
        # by make_metrics_callback carry `fid_calibrated`
        calibrated = getattr(self.metrics_callback, "fid_calibrated", True)
        if self.trial is not None and fid is not None and calibrated:
            self.trial.report(fid, global_step)
            if self.trial.should_prune() and in_phase_step > self.cfg.optuna_warmup_steps:
                raise TrialPruned()

    def _to_device(self, batch: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """Host batch -> device tensor at the transfer dtype: rounded by torch on the
        host, copied from pinned memory without blocking the host on a CUDA device."""
        t = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------------

    def run(self) -> Optional[float]:
        cfg = self.cfg
        if self._already_complete:
            self._log(f"auto_resume: model_{cfg.ending_phase or cfg.num_phases}.npz already "
                      f"in {self.logdir} — training complete, nothing to do.")
            return self.last_fid
        if self._auto_resume_note:
            self._log(self._auto_resume_note)
        self._log(f"Conv engine: {self.conv_engine} on {self.device}")
        start_train = time.time()
        global_step = 0

        installed = {}
        if cfg.graceful_shutdown and threading.current_thread() is threading.main_thread():
            for s in (signal.SIGTERM, signal.SIGINT):
                installed[s] = signal.signal(s, self._handle_signal)
            self._installed_handlers = installed
        try:
            for phase in range(cfg.starting_phase, cfg.num_phases + 1):
                self.phase = phase
                result = self._run_phase(phase, global_step)
                global_step = result.global_step
                if cfg.ending_phase and phase == cfg.ending_phase:
                    self._log("Reached final phase, breaking.")
                    break
                if self._interrupted() and phase < cfg.num_phases:
                    # the signal landed on the phase's last step: the phase completed
                    # (model_<phase> written) and the next one resumes from it
                    exc = TrainingInterrupted(self._last_checkpoint, phase + 1, global_step)
                    self._log(str(exc))
                    raise exc
        finally:
            for s, prev in installed.items():
                signal.signal(s, prev)
            self._installed_handlers = {}
            self.writer.flush()
        self.train_time = time.time() - start_train
        return self.last_fid

    # ------------------------------------------------------------------

    def _run_phase(self, phase: int, global_step: int) -> PhaseResult:
        cfg = self.cfg
        verbose = self.verbose
        global_size = self.global_size
        dev = self.device

        npy_data = self._get_dataset(phase)
        train_frac = 1 - (cfg.validation_fraction + cfg.test_fraction)
        n = len(npy_data)
        holdout = cfg.validation_fraction + cfg.test_fraction
        # every side of the chained splits must be non-empty
        if holdout > 0:
            n_train = int(np.round(train_frac * n) + 1e-5)
            n_rest = n - n_train
            n_val = int(np.round((cfg.validation_fraction / holdout) * n_rest) + 1e-5)
            splittable = 0 < n_train < n and 0 < n_val < n_rest
        else:
            splittable = False
        if splittable:
            npy_train, npy_testval = npy_data.split_by_fraction(train_frac)
            npy_val, npy_test = npy_testval.split_by_fraction(
                cfg.validation_fraction / (cfg.validation_fraction + cfg.test_fraction))
        else:
            # own draw streams for val/test: sharing the train stream would race the
            # prefetch thread
            npy_train = npy_data
            npy_val = npy_data.clone(seed_offset=1)
            npy_test = npy_data.clone(seed_offset=2)
        self._log(f"Split dataset of {len(npy_data)} samples: train {len(npy_train)}, "
                  f"validation {len(npy_val)}, test {len(npy_test)}")

        batch_size = cfg.batch_size_for_phase(phase, global_size)
        global_batch = batch_size * global_size
        self._log(f"Using local batch size of {batch_size} and global batch size of "
                  f"{global_batch}")

        # --- state ---
        state, (g_optimizer, d_optimizer) = init_train_state(
            self.arch, torch.Generator().manual_seed(cfg.seed), phase=phase, cfg=cfg,
            device=dev)
        state = self._restore_for_phase(phase, state)
        if self.mesh is not None:  # replicated from rank 0
            for tree in (state.g_params, state.d_params, state.ema,
                         *state.g_opt.slots.values(), *state.d_opt.slots.values()):
                broadcast_params_(tree, self.mesh)
        self._log(f"Generator parameters: {sum(v.numel() for v in state.g_params.values())}")
        self._log(f"Discriminator parameters: "
                  f"{sum(v.numel() for v in state.d_params.values())}")

        frozen = (self._prev_phase_names(phase, {**state.g_params, **state.d_params})
                  if cfg.mixing_nimg > 0 else frozenset())
        engine = self.conv_engine
        lazy_k = max(1, int(cfg.lazy_gp))
        steps = {}

        def step_fn(mixing: bool, use_gp: bool, hists: bool):
            """The step variant: mixing with the previous phase's names frozen and alpha
            as a number, or stabilizing at static alpha 0; with or without the penalty
            (lazy_gp) and the histograms (summary steps)."""
            key = (mixing, use_gp, hists)
            if key not in steps:
                steps[key] = make_train_step(
                    self.arch, cfg, phase, g_optimizer, d_optimizer,
                    frozen_names=frozen if mixing else frozenset(),
                    freeze=bool(frozen) and mixing, apply_gp=use_gp, grad_histograms=hists,
                    static_alpha=None if mixing else 0.0, conv_engine=engine, mesh=self.mesh)
            return steps[key]

        eval_losses = self._make_eval_losses(phase)
        sample = self._make_sample_fn(phase)
        run_metrics = cfg.calc_metrics and self.metrics_callback is not None

        # --- LR ---
        g_lr_max, d_lr_max = scale_lr(cfg.g_lr, cfg.d_lr, cfg.g_scaling, cfg.d_scaling,
                                      global_size)
        steps_per_phase = cfg.mixing_nimg + cfg.stabilizing_nimg
        # this run's image count at which the phase began: the base of the mixing flip
        # and the phase exit, and what a full-state save stores
        phase_start_step = (phase - cfg.starting_phase) * steps_per_phase + self._step_offset

        # --- alpha ---
        alpha = float(cfg.starting_alpha) if phase == cfg.starting_phase else 1.0
        if cfg.mixing_nimg == 0:
            alpha = 0.0
        alpha_steps = max(1, cfg.mixing_nimg // global_batch) if cfg.mixing_nimg > 0 else 1
        alpha_delta = cfg.starting_alpha / alpha_steps

        mixing_bool = cfg.mixing_nimg > 0
        local_step = 0
        in_phase_step = 0
        resume = self.__dict__.pop("_resume_counters", None)
        if resume:
            alpha = float(resume.get("alpha", alpha))
            in_phase_step = int(resume.get("in_phase_step", 0))
            local_step = int(resume.get("local_step", 0))
            global_step = int(resume.get("global_step", global_step))
            # rebase the thresholds onto this run's schedule: the stored global_step
            # counts from the original run's starting_phase; moving the threshold base
            # (not global_step) keeps file names and the event x-axis monotone
            stored_psp = int(resume.get("phase_start_step", 0))
            self._step_offset += stored_psp - phase_start_step
            phase_start_step = stored_psp
            mixing_bool = bool(resume.get("mixing", mixing_bool)) and cfg.mixing_nimg > 0
            # replay the uninterrupted run's batch sequence: completed steps consumed
            # (local_step / batch_size) * global_batch paths of the shuffle stream
            if local_step and hasattr(npy_train, "fast_forward"):
                npy_train.fast_forward((local_step // batch_size) * global_batch)
            self._log(f"Resumed counters: step {global_step}, alpha {alpha}, "
                      f"mixing {mixing_bool}")
        seed_base = cfg.seed + phase * 1000
        img_s = local_img_s = 0.0

        def full_state_counters():
            return {"global_step": global_step, "in_phase_step": in_phase_step,
                    "local_step": local_step, "alpha": alpha, "mixing": mixing_bool,
                    "phase": phase, "phase_start_step": phase_start_step}

        transfer_dtype = resolve_transfer_dtype(cfg)
        shard = rank(self.mesh)

        def make_batch():
            if self.mesh is not None:  # this rank's share of the global batch
                b = npy_train.batch_sharded(batch_size, global_size, shard)
            else:
                b = npy_train.batch(global_batch)
            b = normalize_numpy(b, cfg.data_mean, cfg.data_stddev)
            return self._to_device(b, transfer_dtype)

        prefetcher, pipeline = None, "none"
        if self.prefetch:
            both = (cfg.data_mean is None) == (cfg.data_stddev is None)
            if (cfg.native_prefetch and both and hasattr(npy_train, "batch_paths")
                    and getattr(npy_train, "shape", None) is not None):
                # paths in Python (the deterministic stream, this rank's [rank::world]),
                # read, normalize and round on the C++ pool into pinned memory
                def paths_fn():
                    return npy_train.batch_paths(global_batch)[shard::global_size]

                host = NativeBatchPrefetcher(paths_fn, npy_train.shape, cfg.data_mean,
                                             cfg.data_stddev, out_dtype=transfer_dtype,
                                             pin_memory=dev.type == "cuda")
                prefetcher, pipeline = _OnDevice(host, dev), "native"
                self._log("Input pipeline: native C++ prefetcher (csrc/host/saragan_io.cc)")
            else:
                prefetcher, pipeline = Prefetcher(make_batch), "python_thread"
                self._log("Input pipeline: Python prefetch thread")
        self.writer.text("config/input_pipeline", pipeline, global_step)
        self._log(f"Begin mixing epochs in phase {phase}" if mixing_bool
                  else f"Begin stabilizing epochs in phase {phase}")

        timed = dev.type == "cuda"
        if timed:
            torch.cuda.reset_peak_memory_stats(dev)
        events = []  # (half, global_step, start event, end event)
        step_idx = 0
        profiler = None  # the profile_dir trace of steps 5 to 10 of the starting phase
        profile_steps = (5, 10) if cfg.profile_dir and phase == cfg.starting_phase else None
        window_t0 = time.time()
        window_imgs = 0
        metrics = None
        input_wait = []  # host seconds spent waiting for each step's batch
        try:
            while True:
                d_lr_val = lr_schedule(in_phase_step, steps_per_phase, d_lr_max,
                                       cfg.d_lr_increase, cfg.d_lr_decrease,
                                       cfg.d_lr_rise_niter, cfg.d_lr_decay_niter)
                g_lr_val = lr_schedule(in_phase_step, steps_per_phase, g_lr_max,
                                       cfg.g_lr_increase, cfg.g_lr_decrease,
                                       cfg.g_lr_rise_niter, cfg.g_lr_decay_niter)
                if not mixing_bool:
                    assert alpha == 0.0

                if global_step % cfg.checkpoint_every_nsteps < global_batch and local_step > 0:
                    self._save_phase_checkpoint(phase, state, global_step, step=global_step)
                    if cfg.full_state_checkpoints:
                        ckpt.save_full_state(
                            ckpt.phase_checkpoint_path(self.logdir, phase, global_step)
                            + "_full", state, full_state_counters())
                        self._supersede_consumed_interrupt()

                t_input = time.perf_counter()
                batch = next(prefetcher) if prefetcher else make_batch()
                input_wait.append(time.perf_counter() - t_input)

                small_summary_bool = local_step % cfg.summary_small_every_nsteps < batch_size
                large_summary_bool = local_step % cfg.summary_large_every_nsteps < batch_size
                summary = small_summary_bool or large_summary_bool
                metrics_step = run_metrics and local_step % cfg.metrics_every_nsteps < batch_size
                if profile_steps and step_idx == profile_steps[0]:
                    profiler = self._start_profiler()

                # the lazy-GP cadence follows local_step, which a resume restores
                use_gp = lazy_k == 1 or ((local_step // batch_size) % lazy_k == 0)
                want_hists = summary and verbose and cfg.grad_histograms
                fn = step_fn(mixing_bool, use_gp, want_hists)
                if self.draws_fn is not None:
                    gen, draws = None, self.draws_fn(phase, local_step)
                else:
                    gen, draws = step_generator(seed_base, 2 * local_step, dev), None
                if timed:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                state, metrics = fn(state, batch, gen, alpha, g_lr_val, d_lr_val, draws=draws)
                if timed:
                    end.record()
                    events.append(("mixing" if mixing_bool else "stabilizing", global_step,
                                   start, end))

                if profiler is not None and step_idx == profile_steps[1]:
                    self._stop_profiler(profiler, phase, profile_steps)
                    profiler = None
                if step_idx == 0:
                    # the first step's kernel builds and compiles stay out of the window
                    _ = float(metrics.gen_loss)
                    window_t0 = time.time()
                    window_imgs = -global_batch  # cancels the += below
                step_idx += 1
                window_imgs += global_batch

                if summary:
                    d_loss = float(metrics.disc_loss)  # the device sync closes the window
                    g_loss = float(metrics.gen_loss)
                    if np.isfinite(d_loss) and np.isfinite(g_loss):
                        # a checkpoint is known good once a LATER summary came back finite
                        self._last_finite_checkpoint = self._last_checkpoint
                        self._last_finite_checkpoint_phase = self._last_checkpoint_phase
                    elif cfg.abort_on_nonfinite:
                        raise TrainingDiverged(phase, global_step, d_loss, g_loss,
                                               self._last_finite_checkpoint,
                                               self._last_finite_checkpoint_phase)
                    now = time.time()
                    if now > window_t0 and window_imgs > 0:
                        img_s = window_imgs / (now - window_t0)
                        local_img_s = img_s / global_size
                        self.last_img_s = img_s
                    self._write_summaries(phase, state, metrics, npy_val, batch_size,
                                          global_step, alpha, g_lr_val, d_lr_val, eval_losses,
                                          step_generator(seed_base, 2 * local_step + 1, dev),
                                          large=large_summary_bool, mixing=mixing_bool)
                else:
                    d_loss = g_loss = None

                global_step += global_batch
                local_step += batch_size
                in_phase_step += global_batch
                if mixing_bool:
                    alpha = max(alpha - alpha_delta, 0.0)

                if metrics_step:
                    t_metrics = time.time()
                    self._run_metrics(state, npy_val, sample, global_step, in_phase_step,
                                      alpha)
                    self.writer.scalar("Timing/metrics_s", time.time() - t_metrics, global_step)

                if summary or metrics_step:
                    # summary and metric host time stays out of the next window
                    window_t0 = time.time()
                    window_imgs = 0
                if verbose and summary:
                    self.writer.scalar("img_s", img_s, global_step)
                    summ.print_summary_to_stdout(global_step, in_phase_step, img_s,
                                                 local_img_s, d_loss, g_loss, d_lr_val,
                                                 g_lr_val, alpha)

                # mixing -> stabilizing flip
                if mixing_bool and global_step >= phase_start_step + cfg.mixing_nimg:
                    mixing_bool = False
                    alpha = 0.0
                    self._log(f"Begin stabilizing epochs in phase {phase}")
                if mixing_bool:
                    assert alpha >= 0

                # the phase exit is decided before the interrupt unwinds: a signal on
                # the phase's last step completes the phase instead
                phase_done = global_step >= phase_start_step + steps_per_phase

                if self._interrupted() and not phase_done:
                    resume_path = ckpt.save_full_state(
                        ckpt.phase_checkpoint_path(self.logdir, phase, global_step)
                        + "_interrupt", state, full_state_counters())
                    if resume_path != self._consumed_interrupt:
                        self._supersede_consumed_interrupt()
                    self._save_phase_checkpoint(phase, state, global_step, step=global_step)
                    self.state = state
                    exc = TrainingInterrupted(resume_path, phase, global_step)
                    self._log(str(exc))
                    raise exc

                if phase_done:
                    break
        finally:
            if prefetcher:
                prefetcher.stop()
            if profiler is not None:  # the phase ended before step 10
                self._stop_profiler(profiler, phase, profile_steps)

        self._log("\n\n\n End of phase.")
        if len(input_wait) > 1:
            self.writer.scalar("Timing/input_wait_ms",
                               1e3 * float(np.mean(input_wait[1:])), global_step)
        if window_imgs > 0 and time.time() > window_t0:
            _ = float(metrics.gen_loss)  # device sync
            img_s = window_imgs / (time.time() - window_t0)
            self.last_img_s = img_s
        if timed:
            torch.cuda.synchronize(dev)
            for half, gs, start, end in events:
                self.writer.scalar(f"Timing/step_ms_{half}", start.elapsed_time(end), gs)
            self.writer.scalar("memory/phase_peak_bytes",
                               torch.cuda.max_memory_allocated(dev), global_step)

        # the phase-final checkpoint with the EMA folded into the weights
        folded = fold_ema({**state.g_params, **state.d_params}, state.ema)
        g_f, d_f = split_params(folded)
        state = state._replace(g_params=g_f, d_params=d_f)
        self.state = state
        self._save_phase_checkpoint(phase, state, global_step)
        self._supersede_consumed_interrupt()

        # end-of-phase metrics under the EMA weights (the EMA tree itself, whether or not
        # it is folded into the live weights)
        if run_metrics:
            ema_sampler = _sampler(sample, split_params(state.ema)[0], 0.0)
            for flag, ds, tag in ((cfg.compute_metrics_test, npy_test, "test"),
                                  (cfg.compute_metrics_validation, npy_val, "validation"),
                                  (cfg.compute_metrics_train, npy_train, "train")):
                if flag and len(ds) > 0:
                    m = self.metrics_callback(self, ema_sampler, ds, global_step, f"_{tag}")
                    self._log(f"{tag} dataset metrics: {m}")
                    if tag == "validation" and m and m.get("FID") is not None:
                        self.last_fid = float(m["FID"])
        return PhaseResult(phase, global_step, self.last_fid, img_s)

    def _interrupted(self) -> bool:
        """Whether a signal arrived, on this rank or, under a mesh, on any rank (agreed
        over the host group, so that every rank stops after the same step)."""
        hit = self._interrupt is not None
        if self.mesh is not None and self.mesh.world_size > 1:
            agreed = any_rank(hit, self.mesh)
            if agreed and not hit:
                self._interrupt = signal.SIGTERM  # another rank's signal
                for s, prev in self._installed_handlers.items():
                    signal.signal(s, prev)
                self._installed_handlers = {}
            hit = agreed
        return hit

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, phase: int, steps):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"trace_phase{phase}_steps{steps[0]}-{steps[1]}.json")
        profiler.export_chrome_trace(path)
        self._log(f"Wrote a profiler trace of steps {steps[0]}-{steps[1]}: {path}")

    # ------------------------------------------------------------------

    def _write_summaries(self, phase, state, metrics, npy_val, batch_size, global_step, alpha,
                         g_lr_val, d_lr_val, eval_losses, gen, large: bool, mixing: bool):
        cfg = self.cfg
        if not self.verbose:
            return
        w = self.writer
        w.scalars(summ.training_props_summary(alpha, g_lr_val, d_lr_val), global_step)
        mem = summ.memory_summary(self.device)
        if mem:
            w.scalars(mem, global_step)
        suffix = "_freeze" if mixing and phase > cfg.starting_phase else ""
        w.scalars(summ.gradients_summary(float(metrics.max_g_norm), float(metrics.max_d_norm),
                                         suffix), global_step)
        for tree in (metrics.g_norms, metrics.d_norms):
            if tree:
                w.scalars({f"grad_norm/{k}{suffix}": float(v) for k, v in tree.items()},
                          global_step)
        for tree in (metrics.g_hists, metrics.d_hists):
            if tree:
                for k, (counts, edges) in tree.items():
                    w.histogram_raw(f"Loss/grad_{k}{suffix}", counts.cpu().numpy(),
                                    edges.cpu().numpy(), global_step)
        w.scalars(summ.small_summary(
            metrics.disc_loss, metrics.gen_loss, metrics.gp_loss,
            (float(metrics.fake_min), float(metrics.fake_max)),
            (float(metrics.real_min), float(metrics.real_max))), global_step)
        # validation losses under the training weights and under the EMA
        if len(npy_val) > 0:
            val_batch = normalize_numpy(npy_val.batch(batch_size), cfg.data_mean,
                                        cfg.data_stddev).astype(np.float32)
            val_dev = self._to_device(val_batch, resolve_transfer_dtype(cfg))
            gl, dl, gpl, _ = eval_losses(state.g_params, state.d_params, val_dev, gen, alpha)
            w.scalars({"Loss/d_loss_val": float(dl), "Loss/g_loss_val": float(gl),
                       "Loss/gp_val": float(gpl)}, global_step)
            g_ema, d_ema = split_params(state.ema)
            gl, dl, gpl, fake_ema = eval_losses(g_ema, d_ema, val_dev, gen, alpha)
            fake = fake_ema.float().cpu().numpy()
            w.scalars(summ.small_summary(dl, gl, gpl, fake, val_batch, "_EMA"), global_step)
            if large:
                w.image("summaries/fake_image_EMA", summ.image_grid(fake), global_step)
                w.image("summaries/real_image", summ.image_grid(val_batch), global_step)
