"""The trainer's metric passes and its profiler trace, on the CPU.

* The cadence against the JAX package's Trainer: with the same configuration and a stub
  callback, both call it at the same steps with the same suffixes (``""`` and ``_EMA``
  every ``metrics_every_nsteps``; ``_test``, ``_validation``, ``_train`` under the EMA at
  each phase's end) on splits of the same sizes, hand it samplers of the same output
  shape, and end on the same ``last_fid`` (the last validation FID).
* A run with ``make_metrics_callback`` and every metric on writes the reference's tags
  (``fid``, ``PSNR``, ``ssim``, ``MSE``, ``NRMSE``, ``swd_16``, ``swd_mean``, each plain,
  ``_EMA``, ``_validation`` and ``_test``), finite, and ``Timing/metrics_s``.
* The CLI builds the callback when ``--calc_metrics`` is given, and ``--compute_FID``
  without weights or ``--allow_uncalibrated_fid`` fails before training.
* ``profile_dir``: a Chrome trace of steps 5-10 of the starting phase (cut at the phase's
  end when it is shorter; none where the phase ends before step 5).
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.train.trainer import Trainer as JaxTrainer
from saragan_tpu_torch.cli import main as cli_main
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.metrics.fid import RandomConvFeatures, UncalibratedFIDError
from saragan_tpu_torch.metrics.save_metrics import make_metrics_callback
from saragan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def make_data(root, sizes, n=12):
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
             summary_small_every_nsteps=1_000, summary_large_every_nsteps=1_000,
             filter_spec=[[8, 8], [8, 8]], loss_fn="wgan", gp_weight=10.0, noise_stddev=0.0,
             g_lr=1e-3, d_lr=1e-3, validation_fraction=0.2, test_fraction=0.2,
             grad_histograms=False)
    d.update(kw)
    return d


def events(logdir):
    with open(os.path.join(logdir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_metric_cadence_matches_reference_trainer(tmp_path):
    make_data(tmp_path / "data", (4, 8))
    kw = base_cfg(tmp_path, calc_metrics=True, metrics_every_nsteps=8,
                  compute_metrics_train=True)
    calls = {}

    def stub(name, key_of):
        calls[name] = []

        def callback(trainer, sampler, dataset, step, suffix):
            fake = np.asarray(sampler(key_of(step), 2))
            assert fake.dtype == np.float32 and np.all(np.isfinite(fake))
            calls[name].append((trainer.phase, step, suffix, len(dataset), fake.shape))
            return {"FID": step + 0.25 * len(suffix)}

        return callback

    jt = JaxTrainer(JaxConfig(**kw, logdir=str(tmp_path / "ref")).finalize(), verbose=False,
                    prefetch=False, metrics_callback=stub("jax", jax.random.PRNGKey))
    ref_fid = jt.run()
    ours = Trainer(Config(**kw, logdir=str(tmp_path / "port")).finalize(), device="cpu",
                   verbose=False, prefetch=False,
                   metrics_callback=stub("torch", lambda s: torch.Generator().manual_seed(s)))
    our_fid = ours.run()
    assert calls["torch"] == calls["jax"]
    suffixes = [c[2] for c in calls["jax"]]
    assert {"", "_EMA", "_test", "_validation", "_train"} <= set(suffixes)
    assert our_fid == ref_fid == ours.last_fid and ref_fid is not None


def test_trainer_writes_the_metric_tags(tmp_path):
    make_data(tmp_path / "data", (16,))
    cfg = Config(**base_cfg(
        tmp_path, start_shape="(1, 16, 16, 16)", final_shape="(1, 32, 32, 32)",
        ending_phase=1, filter_spec=[[8, 8]], mixing_nimg=0, stabilizing_nimg=8,
        logdir=str(tmp_path / "run"), calc_metrics=True, metrics_every_nsteps=8,
        compute_FID=True, compute_swds=True, compute_ssims=True, compute_psnrs=True,
        compute_mses=True, compute_nrmses=True, num_metric_samples=2,
        metrics_batch_size=2)).finalize()
    # a 32-d random-feature extractor keeps the Frechet distance's square root small
    callback = make_metrics_callback(cfg, extractor=RandomConvFeatures(out_dim=32,
                                                                       device="cpu"))
    assert callback.fid_calibrated is False
    trainer = Trainer(cfg, device="cpu", prefetch=False, metrics_callback=callback)
    fid = trainer.run()
    ev = events(tmp_path / "run")
    tags = {e["tag"] for e in ev}
    for base in ("fid", "PSNR", "ssim", "MSE", "NRMSE", "swd_16", "swd_mean"):
        for suffix in ("", "_EMA", "_validation", "_test"):
            vals = [e["value"] for e in ev if e["tag"] == base + suffix]
            assert vals and all(math.isfinite(v) for v in vals), base + suffix
    assert "fid_train" not in tags  # compute_metrics_train is off by default
    metric_steps = sorted({e["step"] for e in ev if e["tag"] == "fid"})
    assert metric_steps == [4]  # after the step at local_step 0 of two (batch 4, every 8)
    assert [e["step"] for e in ev if e["tag"] == "Timing/metrics_s"] == metric_steps
    assert fid == [e["value"] for e in ev if e["tag"] == "fid_validation"][-1]


def test_cli_builds_the_callback_and_refuses_uncalibrated_fid(tmp_path, monkeypatch):
    monkeypatch.delenv("SARAGAN_INCEPTION_NPZ", raising=False)
    monkeypatch.delenv("SARAGAN_ALLOW_UNCALIBRATED_FID", raising=False)
    make_data(tmp_path / "data", (4,))
    argv = ["pgan", str(tmp_path / "data"), "--start_shape", "(1, 4, 4, 4)",
            "--final_shape", "(1, 8, 8, 8)", "--starting_phase", "1", "--ending_phase", "1",
            "--latent_dim", "8", "--network_size", "xxs", "--base_batch_size", "4",
            "--mixing_nimg", "0", "--stabilizing_nimg", "4", "--noise_stddev", "0",
            "--g_lr", "1e-3", "--d_lr", "1e-3", "--loss_fn", "wgan", "--device", "cpu",
            "--disable_grad_histograms", "--calc_metrics", "--compute_psnrs",
            "--compute_mses", "--metrics_every_nsteps", "4"]
    with pytest.raises(UncalibratedFIDError):
        cli_main(argv + ["--compute_FID", "--logdir", str(tmp_path / "refused")])
    assert not os.path.exists(tmp_path / "refused")  # failed before training
    cli_main(argv + ["--logdir", str(tmp_path / "run")])
    tags = {e["tag"] for e in events(tmp_path / "run")}
    assert {"PSNR", "PSNR_EMA", "MSE", "MSE_validation", "PSNR_test"} <= tags


# 12 steps: the trace of steps 5-10; 6 steps: cut at the phase's end after step 5;
# 4 steps: the phase ends before step 5, so there is nothing to trace
@pytest.mark.parametrize("images,written", [(48, True), (24, True), (16, False)])
def test_profile_dir_writes_a_chrome_trace(tmp_path, images, written):
    make_data(tmp_path / "data", (4,))
    cfg = Config(**base_cfg(tmp_path, final_shape="(1, 8, 8, 8)", ending_phase=1,
                            filter_spec=[[8, 8]], mixing_nimg=0, stabilizing_nimg=images,
                            logdir=str(tmp_path / "run"),
                            profile_dir=str(tmp_path / "prof"))).finalize()
    Trainer(cfg, device="cpu", prefetch=False, verbose=False).run()
    if not written:
        assert not os.path.exists(tmp_path / "prof")
        return
    assert os.listdir(tmp_path / "prof") == ["trace_phase1_steps5-10.json"]
    with open(tmp_path / "prof" / "trace_phase1_steps5-10.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)  # the steps' ops were recorded
