"""The port's phase-loop trainer: a two-phase run against the JAX package's Trainer,
phase chaining by name, bitwise resume after a preemption, the CLI's SIGTERM path, an
HPO trial and study through the trainer and the CLI, and the options that are not
ported.

Parity run: a tiny pgan (start (1,4,4,4), final (1,16,16,16), latent 16, batch 4 then 2,
8 + 8 images per half) with the same data, the same draws (the port's through
``draws_fn``: the reference's own ``fold_in`` keys) and the same parameters: both start
from one npz of the reference's init by ``continue_path``, and the port's phase-2 init
is replaced by the reference's so every name can be compared (the port's own init of
the new layers is checked by ``test_phase_chaining_restores_every_name_bit_for_bit``).
Tolerances: parameters and EMA of ``model_1.npz`` / ``model_2.npz`` within
1e-5 * max|p|, the largest magnitude in the checkpoint's dict (Adam moves a parameter by
about lr * g / |g|, so a near-zero gradient summed in another order can move one tiny
bias entry by ~1e-9 more or less: a per-tensor relative limit would measure that, not
the trainer); training losses within 1e-4 relative (f32; the engines sum in other
orders)."""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.train import checkpoint as jax_ckpt
from saragan_tpu.train.trainer import Trainer as JaxTrainer
from saragan_tpu_torch import losses
from saragan_tpu_torch.cli import main as cli_main
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import params_from_numpy
from saragan_tpu_torch.data.dataset import NumpyPathDataset
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.optim.ema import ema_init
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train import trainer as trainer_mod
from saragan_tpu_torch.train.step import init_train_state, split_params
from saragan_tpu_torch.train.trainer import Trainer, TrainingInterrupted

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_data(root, sizes=(4, 8), n=12):
    rng = np.random.default_rng(0)
    for size in sizes:
        d = os.path.join(root, f"{size}x{size}")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            np.save(os.path.join(d, f"{i:04d}.npy"),
                    rng.normal(size=(size,) * 3).astype(np.float32))


def base_cfg(tmp_path, **kw):
    d = dict(architecture="pgan", dataset_path=str(tmp_path / "data"),
             start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)", starting_phase=1,
             ending_phase=2, latent_dim=16, base_batch_size=4, mixing_nimg=8,
             stabilizing_nimg=8, checkpoint_every_nsteps=10_000,
             summary_small_every_nsteps=4, summary_large_every_nsteps=1_000,
             filter_spec=[[8, 8], [8, 8]], loss_fn="wgan",
             gp_weight=10.0, noise_stddev=0.0, g_lr=1e-3, d_lr=1e-3,
             validation_fraction=0.2, test_fraction=0.2, grad_histograms=False)
    d.update(kw)
    return d


def events(logdir):
    with open(os.path.join(logdir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ref_params(jcfg, phase):
    return {k: np.asarray(v) for k, v in
            jax_arch("pgan").init(jax.random.PRNGKey(jcfg.seed), phase=phase, cfg=jcfg).items()}


def test_two_phase_run_matches_reference_trainer(tmp_path, monkeypatch):
    make_data(tmp_path / "data")
    kw = base_cfg(tmp_path)
    jcfg0 = JaxConfig(**kw).finalize()
    init_npz = jax_ckpt.save_params(str(tmp_path / "init_1"), _ref_params(jcfg0, 1))

    jcfg = JaxConfig(**kw, logdir=str(tmp_path / "ref"), continue_path=init_npz).finalize()
    JaxTrainer(jcfg, verbose=True, prefetch=False).run()

    # the port, fed the reference's draws and, in phase 2, the reference's init
    def draws_fn(phase, local_step):
        key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + phase * 1000), 2 * local_step)
        n = jcfg.batch_size_for_phase(phase)
        k_z, _, _, _, k_gamma = jax.random.split(key, 5)
        return losses.Draws(
            torch.from_numpy(np.array(jax.random.normal(k_z, (n, 16)))),
            torch.from_numpy(np.array(jax.random.uniform(k_gamma, (n, 1, 1, 1, 1)))))

    def reference_init(arch, rng, *, phase, cfg, device=None):
        state, opts = init_train_state(arch, rng, phase=phase, cfg=cfg, device=device)
        g, d = split_params(params_from_numpy(_ref_params(jcfg0, phase), device))
        return state._replace(g_params=g, d_params=d, g_opt=opts[0].init(g),
                              d_opt=opts[1].init(d), ema=ema_init({**g, **d})), opts

    monkeypatch.setattr(trainer_mod, "init_train_state", reference_init)
    cfg = Config(**kw, logdir=str(tmp_path / "port"), continue_path=init_npz,
                 conv_engine="flat").finalize()
    Trainer(cfg, device="cpu", prefetch=False, draws_fn=draws_fn).run()

    for phase in (1, 2):
        rp, re_, rm = jax_ckpt.load_params(str(tmp_path / "ref" / f"model_{phase}.npz"))
        op, oe, om = ckpt.load_params(str(tmp_path / "port" / f"model_{phase}.npz"), "cpu")
        assert om == rm and set(op) == set(rp) and set(oe) == set(re_)
        for ours, ref in ((op, rp), (oe, re_)):
            scale = max(np.abs(v).max() for v in ref.values())
            worst = max(np.abs(ours[k].numpy() - v).max() for k, v in ref.items())
            print(f"phase {phase}: max|port - reference| = {worst:.3g} of max|p| {scale:.3g}")
            assert worst <= 1e-5 * scale
    tags = ("Loss/d_loss", "Loss/g_loss", "Loss/gp")
    ref_ev = {(e["tag"], e["step"]): e["value"] for e in events(tmp_path / "ref")
              if e["tag"] in tags}
    our_ev = {(e["tag"], e["step"]): e["value"] for e in events(tmp_path / "port")
              if e["tag"] in tags}
    assert set(our_ev) == set(ref_ev) and len(ref_ev) >= 3 * 6
    for key, v in ref_ev.items():
        np.testing.assert_allclose(our_ev[key], v, rtol=1e-4, atol=1e-6, err_msg=str(key))


def test_phase_chaining_restores_every_name_bit_for_bit(tmp_path):
    """Phase 2 restores every name of model_1.npz exactly; its new layers keep the
    port's own seeded init, and the EMA restarts from the restored weights."""
    cfg = Config(**base_cfg(tmp_path, logdir=str(tmp_path / "logs"))).finalize()
    arch = get_architecture("pgan")
    p1 = arch.init(torch.Generator().manual_seed(9), phase=1, cfg=cfg, device="cpu")
    ckpt.save_params(str(tmp_path / "logs" / "model_1"), p1, ema=p1)
    tr = Trainer(cfg, device="cpu", verbose=False)
    state, _ = init_train_state(arch, torch.Generator().manual_seed(cfg.seed), phase=2, cfg=cfg,
                                device="cpu")
    restored = tr._restore_for_phase(2, state)
    merged = {**restored.g_params, **restored.d_params}
    own = {**state.g_params, **state.d_params}
    assert set(p1) < set(merged)
    for k, v in merged.items():
        assert torch.equal(v, p1[k] if k in p1 else own[k]), k
        assert torch.equal(restored.ema[k], v) and restored.ema[k].data_ptr() != v.data_ptr()


class _SignalAfter(NumpyPathDataset):
    """Raises SIGTERM in the main thread while drawing batch number `after` (the
    trainer runs without prefetch and trains on this very dataset, unsplit): the step of
    that batch completes, then the loop writes the resume point."""

    after = None
    draws = 0

    def batch(self, batch_size, auto_repeat=True):
        type(self).draws += 1
        if type(self).draws == self.after:
            signal.raise_signal(signal.SIGTERM)
        return super().batch(batch_size, auto_repeat)


@pytest.mark.parametrize("lazy_gp", [1, 2])
def test_preempted_resume_end_state_equals_uninterrupted(tmp_path, lazy_gp):
    """tests/test_graceful_shutdown.py:622 on the port: a run preempted mid-phase and
    requeued with the same flags ends bit-identical to an uninterrupted one."""
    make_data(tmp_path / "data", sizes=(4,))
    kw = base_cfg(tmp_path, final_shape="(1, 8, 8, 8)", ending_phase=1, mixing_nimg=24,
                  stabilizing_nimg=24, lazy_gp=lazy_gp, summary_small_every_nsteps=8,
                  grad_histograms=lazy_gp == 1, validation_fraction=0.0, test_fraction=0.0)
    Trainer(Config(**kw, logdir=str(tmp_path / "u")).finalize(), device="cpu").run()

    class Interrupting(_SignalAfter):
        after = 5  # during the fifth batch: global step 16 of 48

    def factory(phase):
        return Interrupting(str(tmp_path / "data" / "4x4"), seed=42)

    cfg_i = Config(**kw, logdir=str(tmp_path / "i"), auto_resume=True).finalize()
    with pytest.raises(TrainingInterrupted) as e:
        Trainer(cfg_i, device="cpu", prefetch=False, dataset_factory=factory).run()
    assert e.value.global_step == 20 and e.value.resume_path.endswith("_interrupt.pkl")
    assert getattr(signal.getsignal(signal.SIGTERM), "__self__", None) is None  # restored

    cfg_r = Config(**kw, logdir=str(tmp_path / "i"), auto_resume=True).finalize()
    tr = Trainer(cfg_r, device="cpu")
    assert cfg_r.continue_path == e.value.resume_path
    tr.run()
    pu, eu, mu = ckpt.load_params(str(tmp_path / "u" / "model_1.npz"), "cpu")
    pi, ei, mi = ckpt.load_params(str(tmp_path / "i" / "model_1.npz"), "cpu")
    assert mu == mi and set(pu) == set(pi)
    for k in pu:
        assert torch.equal(pu[k], pi[k]), k
        assert torch.equal(eu[k], ei[k]), k
    assert not os.path.exists(e.value.resume_path)  # superseded by model_1.npz


def test_sigterm_at_the_cli_exits_75_and_resumes(tmp_path):
    make_data(tmp_path / "data", sizes=(4,))
    logdir = str(tmp_path / "logs")
    spec = tmp_path / "filters.json"
    spec.write_text(json.dumps({"filter_spec": [[8, 8]]}))
    cmd = [sys.executable, "-u", "-m", "saragan_tpu_torch", "pgan", str(tmp_path / "data"),
           "--start_shape", "(1, 4, 4, 4)", "--final_shape", "(1, 8, 8, 8)",
           "--starting_phase", "1", "--ending_phase", "1", "--latent_dim", "16",
           "--filter_spec", str(spec), "--base_batch_size", "4", "--mixing_nimg", "64",
           "--stabilizing_nimg", "8", "--noise_stddev", "0.0", "--g_lr", "1e-3",
           "--d_lr", "1e-3", "--loss_fn", "wgan", "--summary_small_every_nsteps", "8",
           "--disable_grad_histograms", "--logdir", logdir, "--device", "cpu",
           "--auto_resume"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if "\tStep " in line:
                break
        p.send_signal(signal.SIGTERM)
        rest = p.stdout.read()
        rc = p.wait(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    out = "".join(lines) + rest
    assert rc == 75, out[-3000:]
    assert "INTERRUPTED" in out and "--continue_path" in out
    assert len([f for f in os.listdir(logdir) if f.endswith("_interrupt.pkl")]) == 1
    again = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stdout[-3000:] + again.stderr[-3000:]
    assert "auto_resume: continuing from" in again.stdout
    assert os.path.isfile(os.path.join(logdir, "model_1.npz"))
    assert not [f for f in os.listdir(logdir) if f.endswith("_interrupt.pkl")]


class FakeTrial:
    """An HPO trial that records its reports and asks to prune every time."""

    def __init__(self):
        self.reports = []

    def report(self, value, step):
        self.reports.append((value, step))

    def should_prune(self):
        return True


@pytest.mark.parametrize("change,match", [  # ids as before calc_metrics and profile_dir
    pytest.param(dict(horovod=True, num_space_shards=2), "item 16", id="change1-mesh"),
    pytest.param(dict(dataset="imagenet"), None, id="change3-ImageNet")])
def test_unported_options_raise(tmp_path, change, match):
    """The mesh's spatial axes raise (its data axis is ported since: one process per
    device, tests/test_torch_multiprocess.py); the ImageNet dataset, ported since, takes
    the JPEG class folders under the dataset path (tests/test_torch_2d.py holds it to the
    reference)."""
    cfg = Config(**base_cfg(tmp_path, **change)).finalize()
    if match is None:
        from PIL import Image

        from saragan_tpu_torch.data.imagenet import ImageDatasetAdapter

        for split in ("train", "test"):
            (tmp_path / "data" / split / "n001").mkdir(parents=True)
            Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
                tmp_path / "data" / split / "n001" / "a.JPEG")
        ds = Trainer(cfg, device="cpu", verbose=False)._get_dataset(1)
        assert isinstance(ds, ImageDatasetAdapter) and ds.batch(2).shape == (2, 1, 4, 4)
    else:
        with pytest.raises(NotImplementedError, match=match):
            Trainer(cfg, device="cpu")
    # an HPO trial runs (HPO is ported): without metrics nothing is reported or pruned
    make_data(tmp_path / "data")
    trial = FakeTrial()
    tr = Trainer(Config(**base_cfg(tmp_path, ending_phase=1,
                                   logdir=str(tmp_path / "trial"))).finalize(),
                 device="cpu", trial=trial, verbose=False)
    assert tr.trial is trial and tr.run() is None and trial.reports == []
    assert (tmp_path / "trial" / "model_1.npz").is_file()


def test_cli_refuses_hpo_and_unset_values(tmp_path):
    """The CLI runs an HPO study (an in-memory one here: two trials of one tiny phase),
    and refuses a run whose values no trial fills."""
    make_data(tmp_path)
    argv = ["pgan", str(tmp_path), "--start_shape", "(1, 4, 4, 4)", "--final_shape",
            "(1, 8, 8, 8)", "--starting_phase", "1", "--ending_phase", "1", "--latent_dim",
            "16", "--noise_stddev", "0", "--g_lr", "1e-3", "--d_lr", "1e-3", "--device", "cpu"]
    study = cli_main(argv + ["--base_batch_size", "4", "--optuna_ntrials", "2",
                             "--mixing_nimg", "4", "--stabilizing_nimg", "4",
                             "--disable_grad_histograms", "--logdir", str(tmp_path / "hpo")])
    assert [t.state for t in study.trials] == ["COMPLETE", "COMPLETE"]
    assert all("g_lr_sched_inc" in t.params for t in study.trials)
    with pytest.raises(ValueError, match="base_batch_size"):
        cli_main(argv)


def test_cli_trains_surfgan_and_warm_start_carries_d_z_avg(tmp_path):
    """A style family through the CLI on the CPU: phases 1 -> 2 write model_1.npz and
    model_2.npz, which the JAX package reads with its surfgan's names and shapes; the
    w-average moves every step (refresh_state), and the phase-2 warm start restores
    ``generator/d_z_avg`` from model_1.npz by name."""
    make_data(tmp_path / "data")
    logdir = tmp_path / "logs"
    cli_main(["surfgan", str(tmp_path / "data"), "--start_shape", "(1, 4, 4, 4)",
              "--final_shape", "(1, 16, 16, 16)", "--starting_phase", "1", "--ending_phase",
              "2", "--latent_dim", "16", "--network_size", "xxs", "--base_batch_size", "4",
              "--mixing_nimg", "8", "--stabilizing_nimg", "8", "--noise_stddev", "0",
              "--g_lr", "1e-3", "--d_lr", "1e-3", "--loss_fn", "wgan", "--gp_weight", "10",
              "--disable_grad_histograms", "--logdir", str(logdir), "--device", "cpu"])
    m1, _, _ = ckpt.load_params(str(logdir / "model_1.npz"), "cpu")
    m2, _, _ = ckpt.load_params(str(logdir / "model_2.npz"), "cpu")
    avg1, avg2 = m1["generator/d_z_avg"], m2["generator/d_z_avg"]
    assert avg1.abs().max() > 0 and not torch.equal(avg1, avg2)
    assert all(torch.isfinite(v).all() for v in m2.values())
    cfg_kw = base_cfg(tmp_path, architecture="surfgan", network_size="xxs", filter_spec=None,
                      logdir=str(logdir))
    ref = jax_arch("surfgan").init(jax.random.PRNGKey(0), phase=2,
                                   cfg=JaxConfig(**cfg_kw).finalize())
    ref_params, ref_ema, _ = jax_ckpt.load_params(str(logdir / "model_2.npz"))
    for loaded in (ref_params, ref_ema):
        assert {k: v.shape for k, v in loaded.items()} == {k: v.shape for k, v in ref.items()}
    cfg = Config(**cfg_kw).finalize()
    state, _ = init_train_state(get_architecture("surfgan"), torch.Generator().manual_seed(0),
                                phase=2, cfg=cfg, device="cpu")
    restored = Trainer(cfg, device="cpu", verbose=False)._restore_for_phase(2, state)
    assert torch.equal(restored.g_params["generator/d_z_avg"], avg1)
