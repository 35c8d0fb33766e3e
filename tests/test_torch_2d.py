"""The 2-D path of the port against the JAX package on the CPU.

* The six families' G (sampling and training mode) and D forwards in 2-D from the
  reference's own parameters, and one train step of each from one converted TrainState
  (the small 2-D config of ``tests/test_models_all.py``: start (1, 4, 4), latent 16,
  'xxs', 3x3 kernels; phase 2, stylegan2 phase 1), at the f32 tolerances of
  ``tests/test_torch_families.py``: forwards 1e-5 of max|ref|, one step's losses rtol
  1e-4 and its gradients, parameters and EMA by ``assert_step_close``.  The simultaneous
  penalty's literal axes (1, 2, 3) cover every non-batch axis of a 2-D batch, the
  polyphase upscale runs 2^2 phases, the downscale pools 2x2.
* pgan with ``use_pallas_fusion`` (kernel #4 after every G conv) against the reference's
  Pallas kernel in interpret mode; #4's plain version and its backward's plain version at
  2-D shapes (C = 3 and C = 512 among them) against the reference's kernel and jax.vjp.
* The ports of ``tests/test_2d_end_to_end.py``: a two-phase run on JPEG class folders and
  the G Adam / D LAMB run with gradient accumulation, each checkpoint held to the JAX
  trainer's with the reference's draws fed (parameters and EMA within 1e-5 of max|p|,
  losses rtol 1e-4, as ``tests/test_torch_trainer.py``); the dataset autoselection (JPEG
  folders for ``--dataset imagenet`` or a 2-D config with a ``train/`` folder, else the
  2-D npy pyramid), the CLI on both.
* Serving a 2-D checkpoint: (N, 3, H, W) images over HTTP, npy and png, coalesced equal to
  alone; generate's minimal mode.
* ``--calc_metrics`` in 2-D: the port's metric callback does what the reference's does on
  the same real and fake batches: FID and SWD raise the reference's errors (the reference
  computes them on volumes only), SSIM reports nothing, PSNR / MSE / NRMSE agree (rtol
  1e-5).
"""

import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.data.imagenet import imagenet_dataset_factory as jax_imagenet_factory
from saragan_tpu.metrics.save_metrics import make_metrics_callback as jax_metrics_callback
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.ops.pallas_kernels import fused_bias_act_pixelnorm as jax_fused
from saragan_tpu.train import checkpoint as jax_ckpt
from saragan_tpu.train import init_train_state as jax_init_train_state
from saragan_tpu.train import make_train_step as jax_make_train_step
from saragan_tpu.train.trainer import Trainer as JaxTrainer
from saragan_tpu_torch import losses
from saragan_tpu_torch.cli import main as cli_main
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import params_from_numpy, train_state_from_numpy, \
    train_state_to_numpy
from saragan_tpu_torch.data.dataset import NumpyPathDataset
from saragan_tpu_torch.data.imagenet import ImageDatasetAdapter
from saragan_tpu_torch.metrics.fid import RandomConvFeatures
from saragan_tpu_torch.metrics.save_metrics import make_metrics_callback
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.optim.ema import ema_init
from saragan_tpu_torch.optim.factory import make_optimizers_from_config
from saragan_tpu_torch.tools.generate import main as generate_main
from saragan_tpu_torch.tools.serve import GeneratorService, make_server
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train import trainer as trainer_mod
from saragan_tpu_torch.train.step import init_train_state, make_train_step, split_params
from saragan_tpu_torch.train.trainer import Trainer
from test_torch_families import (STYLE, _tree, assert_step_close, jax_style_draws, np32,
                                 step_draws, to_torch)
from test_torch_native_io import jax_native  # noqa: F401  (both decode with libjpeg)

torch.set_num_threads(1)

ARCHS = ["pgan", "pgan2", "pgandeep", "stylegan", "stylegan2", "surfgan"]
N = 4
SMALL_2D = dict(start_shape="(1, 4, 4)", final_shape="(1, 32, 32)", latent_dim=16,
                network_size="xxs", kernel_spec=[[[], [3, 3]], [[3, 3], [3, 3]],
                                                 [[3, 3], [3, 3]]],
                filter_spec=[[8, 8], [8, 8], [4, 4]], conv_kernel_size=(3, 3),
                loss_fn="wgan", gp_weight=10.0, adam_beta1=0.0, adam_beta2=0.9,
                noise_stddev=0.0)


def phase_of(arch):
    return 1 if arch == "stylegan2" else 2


def configs(arch, **kw):
    phase = phase_of(arch)
    args = dict(SMALL_2D, architecture=arch, starting_phase=phase, ending_phase=phase, **kw)
    return JaxConfig(**args).finalize(), Config(**args).finalize()


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for arch in ARCHS:
        jcfg, _ = configs(arch)
        params = jax_arch(arch).init(jax.random.PRNGKey(0), phase=phase_of(arch), cfg=jcfg)
        out[arch] = {k: np.asarray(v) for k, v in params.items()}
    return out


# ---------------------------------------------------------------------------
# The families in 2-D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["sample", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generator_2d_matches_jax(jax_params, arch, train):
    jcfg, cfg = configs(arch)
    phase = phase_of(arch)
    z = jnp.asarray(np.random.default_rng(1).normal(size=(N, 16)), jnp.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_arch(arch).generator(jax_params[arch], z, 0.5, phase=phase, cfg=jcfg,
                                              rng=key, train=train))
    kw = {}
    if arch in STYLE:
        kw["noise"], kw["mix"] = jax_style_draws(arch, cfg, phase, key, N, jnp.float32, train)
    ours = get_architecture(arch).generator(params_from_numpy(jax_params[arch], "cpu"),
                                            to_torch(z), 0.5, phase=phase, cfg=cfg,
                                            conv_engine="flat", train=train, **kw)
    size = 4 * 2 ** (phase - 1)
    assert ours.shape == ref.shape == (N, 1, size, size)
    np.testing.assert_allclose(np32(ours), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_discriminator_2d_matches_jax(jax_params, arch):
    jcfg, cfg = configs(arch)
    phase = phase_of(arch)
    x = jnp.asarray(np.random.default_rng(2).normal(size=cfg.current_shape(phase, N)),
                    jnp.float32)
    ref = np.asarray(jax_arch(arch).discriminator(jax_params[arch], x, 0.5, phase=phase,
                                                  cfg=jcfg))
    ours = get_architecture(arch).discriminator(params_from_numpy(jax_params[arch], "cpu"),
                                                to_torch(x), 0.5, phase=phase, cfg=cfg,
                                                conv_engine="flat")
    assert ours.shape == ref.shape == (N, 1)
    np.testing.assert_allclose(np32(ours), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_2d_matches_jax(arch):
    """WGAN-GP, the shared fake pass and the stacked critic at alpha 0.5 in 2-D: losses,
    gradients, every parameter, the Adam count and the EMA after one step."""
    jcfg, cfg = configs(arch)
    phase = phase_of(arch)
    state, (jgo, jdo) = jax_init_train_state(jax_arch(arch), jax.random.PRNGKey(0),
                                             phase=phase, cfg=jcfg)
    real = np.random.default_rng(10).normal(size=cfg.current_shape(phase, N)).astype(np.float32)
    key = jax.random.PRNGKey(20)
    jstep = jax.jit(jax_make_train_step(jax_arch(arch), jcfg, phase, jgo, jdo))
    jstate, jm = jstep(state, jnp.asarray(real), key, 0.5, 1e-3, 1e-3)
    draws = step_draws(arch, cfg, phase, key, N, jnp.float32, real.shape[1:])
    assert draws.gamma.shape == (N, 1, 1, 1)
    step = make_train_step(get_architecture(arch), cfg, phase,
                           *make_optimizers_from_config(cfg), conv_engine="flat")
    tnew, m = step(train_state_from_numpy(_tree(state), "cpu"), torch.from_numpy(real), None,
                   0.5, 1e-3, 1e-3, draws=draws)
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        np.testing.assert_allclose(np32(getattr(m, name)), np.asarray(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert float(m.gp_loss) > 0
    assert_step_close(train_state_to_numpy(tnew), _tree(jstate), arch)


# ---------------------------------------------------------------------------
# Kernel #4 in 2-D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["sample", "train"])
def test_fused_pgan_generator_2d_matches_jax_pallas(jax_params, train):
    """pgan's G with every bias + lrelu + pixel norm fused, the port's plain version of
    #4 against the reference's Pallas kernel in interpret mode."""
    jcfg, cfg = configs("pgan", use_pallas_fusion=True)
    z = jnp.asarray(np.random.default_rng(3).normal(size=(N, 16)), jnp.float32)
    ref = np.asarray(jax_arch("pgan").generator(jax_params["pgan"], z, 0.5, phase=2, cfg=jcfg,
                                                train=train))
    calls = fba.bias_act_pixelnorm_plain.calls
    ours = get_architecture("pgan").generator(params_from_numpy(jax_params["pgan"], "cpu"),
                                              to_torch(z), 0.5, phase=2, cfg=cfg,
                                              conv_engine="flat", train=train)
    # one per G conv: generator_in's and each later block's two (the RGB heads are linear)
    assert fba.bias_act_pixelnorm_plain.calls - calls == 3
    np.testing.assert_allclose(np32(ours), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


SHAPES_2D = [(2, 3, 16, 16), (2, 16, 8, 8), (2, 512, 4, 4), (1, 512, 8, 8)]


@pytest.mark.parametrize("pixelnorm", [True, False])
@pytest.mark.parametrize("shape", SHAPES_2D, ids=lambda s: "x".join(map(str, s)))
def test_fused_plain_2d_matches_jax_kernel(shape, pixelnorm):
    rng = np.random.default_rng(shape[1])
    x = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape[1]).astype(np.float32)
    ours = fba.bias_act_pixelnorm_plain(torch.from_numpy(x), torch.from_numpy(b), 0.2,
                                        pixelnorm)
    ref = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(b), 0.2, pixelnorm))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES_2D, ids=lambda s: "x".join(map(str, s)))
def test_fused_grad_plain_2d_matches_jax_vjp(shape):
    rng = np.random.default_rng(shape[1] + 1)
    x, gy = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    b = rng.normal(size=shape[1]).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, bb: jax_fused(xx, bb, 0.2, True), jnp.asarray(x),
                     jnp.asarray(b))
    dx_ref, db_ref = vjp(jnp.asarray(gy))
    dx, db = fba.bias_act_pixelnorm_grad_plain(torch.from_numpy(x), torch.from_numpy(b),
                                               torch.from_numpy(gy), 0.2, True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_ref), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The trainer in 2-D (ports of tests/test_2d_end_to_end.py)
# ---------------------------------------------------------------------------


def make_jpegs(root, n=10, size=16, classes=("n001",)):
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        for cls in classes:
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                arr = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"img_{i}.JPEG"))
    return str(root)


def trainer_kw(imagenet_dir, **kw):
    d = dict(architecture="pgan", dataset_path=imagenet_dir, start_shape="(3, 4, 4)",
             final_shape="(3, 16, 16)", starting_phase=1, ending_phase=2, latent_dim=16,
             base_batch_size=4, mixing_nimg=8, stabilizing_nimg=8,
             checkpoint_every_nsteps=10_000, summary_small_every_nsteps=4,
             summary_large_every_nsteps=1_000,
             kernel_spec=[[[], [3, 3]], [[3, 3], [3, 3]]], filter_spec=[[8, 8], [8, 8]],
             conv_kernel_size=(3, 3), loss_fn="wgan", gp_weight=10.0, noise_stddev=0.0,
             g_lr=1e-3, d_lr=1e-3, validation_fraction=0.2, test_fraction=0.2,
             grad_histograms=False)
    d.update(kw)
    return d


def _events(logdir):
    with open(os.path.join(logdir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_against_reference(tmp_path, monkeypatch, kw):
    """The JAX trainer and the port's on the same JPEG folders from one npz of the
    reference's init, the port fed the reference's draws (micro-batch i of an accumulated
    step from the i-th of K keys split from the step key) and, in later phases, the
    reference's init; checkpoints and losses compared phase by phase."""
    jcfg0 = JaxConfig(**kw).finalize()
    first = jcfg0.starting_phase

    def ref_params(phase):
        return {k: np.asarray(v) for k, v in
                jax_arch("pgan").init(jax.random.PRNGKey(jcfg0.seed), phase=phase,
                                      cfg=jcfg0).items()}

    init_npz = jax_ckpt.save_params(str(tmp_path / "init"), ref_params(first))
    jcfg = JaxConfig(**kw, logdir=str(tmp_path / "ref"), continue_path=init_npz).finalize()
    JaxTrainer(jcfg, dataset_factory=jax_imagenet_factory(jcfg, kw["dataset_path"]),
               verbose=True, prefetch=False).run()
    accum = int(jcfg.gradient_accumulation)

    def draws_fn(phase, local_step):
        key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + phase * 1000), 2 * local_step)
        n = jcfg.batch_size_for_phase(phase) // accum
        out = []
        for k in (jax.random.split(key, accum) if accum > 1 else [key]):
            k_z, _, _, _, k_gamma = jax.random.split(k, 5)
            out.append(losses.Draws(
                torch.from_numpy(np.array(jax.random.normal(k_z, (n, 16)))),
                torch.from_numpy(np.array(jax.random.uniform(k_gamma, (n, 1, 1, 1))))))
        return out if accum > 1 else out[0]

    def reference_init(arch, rng, *, phase, cfg, device=None):
        state, opts = init_train_state(arch, rng, phase=phase, cfg=cfg, device=device)
        g, d = split_params(params_from_numpy(ref_params(phase), device))
        return state._replace(g_params=g, d_params=d, g_opt=opts[0].init(g),
                              d_opt=opts[1].init(d), ema=ema_init({**g, **d})), opts

    monkeypatch.setattr(trainer_mod, "init_train_state", reference_init)
    cfg = Config(**kw, logdir=str(tmp_path / "port"), continue_path=init_npz).finalize()
    tr = Trainer(cfg, device="cpu", prefetch=False, draws_fn=draws_fn)
    tr.run()
    assert isinstance(tr._get_dataset(first), ImageDatasetAdapter)
    for phase in range(first, jcfg.ending_phase + 1):
        rp, re_, rm = jax_ckpt.load_params(str(tmp_path / "ref" / f"model_{phase}.npz"))
        op, oe, om = ckpt.load_params(str(tmp_path / "port" / f"model_{phase}.npz"), "cpu")
        assert om == rm and set(op) == set(rp) and set(oe) == set(re_)
        for ours, ref in ((op, rp), (oe, re_)):
            scale = max(np.abs(v).max() for v in ref.values())
            worst = max(np.abs(ours[k].numpy() - v).max() for k, v in ref.items())
            assert worst <= 1e-5 * scale, (phase, worst, scale)
    tags = ("Loss/d_loss", "Loss/g_loss", "Loss/gp")
    ref_ev = {(e["tag"], e["step"]): e["value"] for e in _events(tmp_path / "ref")
              if e["tag"] in tags}
    our_ev = {(e["tag"], e["step"]): e["value"] for e in _events(tmp_path / "port")
              if e["tag"] in tags}
    assert set(our_ev) == set(ref_ev) and len(ref_ev) >= 6
    for key, v in ref_ev.items():
        np.testing.assert_allclose(our_ev[key], v, rtol=1e-4, atol=1e-6, err_msg=str(key))
    return cfg


def test_2d_pgan_two_phase_run_matches_reference(tmp_path, monkeypatch, jax_native):  # noqa: F811
    cfg = run_against_reference(tmp_path, monkeypatch,
                                trainer_kw(make_jpegs(tmp_path / "imagenet")))
    params, _, _ = ckpt.load_params(os.path.join(cfg.logdir, "model_2.npz"), "cpu")
    assert params["generator/generator_block_2/conv_1/weight"].shape == (3, 3, 8, 8)


def test_2d_g_adam_d_lamb_with_accumulation_matches_reference(tmp_path, monkeypatch,
                                                              jax_native):  # noqa: F811
    kw = trainer_kw(make_jpegs(tmp_path / "imagenet"), final_shape="(3, 8, 8)",
                    ending_phase=1, d_lr=2.5e-3, optimizer="Adam",
                    d_use_different_optimizer=True, d_optimizer="LAMB", weight_decay=0.004,
                    gradient_accumulation=2)
    cfg = run_against_reference(tmp_path, monkeypatch, kw)
    assert cfg.d_optimizer == "LAMB" and cfg.optimizer == "Adam"


def test_2d_dataset_autoselection_and_cli(tmp_path):
    """JPEG folders for a 2-D config with a train/ folder or dataset "imagenet" (the
    class count max(1, num_labels)); the 2-D npy pyramid otherwise; the CLI trains each."""
    jpegs = make_jpegs(tmp_path / "imagenet", classes=("n001", "n002"))
    kw = trainer_kw(jpegs, logdir=str(tmp_path / "a"))
    ds = Trainer(Config(**kw).finalize(), device="cpu", verbose=False)._get_dataset(1)
    assert isinstance(ds, ImageDatasetAdapter) and ds.shape == (1, 3, 4, 4) and len(ds) == 10
    two = Trainer(Config(**dict(kw, num_labels=2)).finalize(), device="cpu",
                  verbose=False)._get_dataset(2)
    assert len(two) == 20 and set(two.labels) == {0, 1} and two.size == 8
    explicit = Config(**dict(kw, dataset="imagenet", start_shape="(3, 4, 4, 4)",
                             final_shape="(3, 16, 16, 16)")).finalize()
    assert isinstance(Trainer(explicit, device="cpu", verbose=False)._get_dataset(1),
                      ImageDatasetAdapter)
    # the npy pyramid of 2-D images: {S}x{S}/*.npy, one (S, S) image a file
    npy = tmp_path / "npy"
    for size in (4, 8):
        (npy / f"{size}x{size}").mkdir(parents=True)
        for i in range(6):
            np.save(npy / f"{size}x{size}" / f"{i}.npy",
                    np.random.default_rng(i).normal(size=(size, size)).astype(np.float32))
    kw_npy = trainer_kw(str(npy), start_shape="(1, 4, 4)", final_shape="(1, 16, 16)",
                        logdir=str(tmp_path / "n"))
    ds = Trainer(Config(**kw_npy).finalize(), device="cpu", verbose=False)._get_dataset(1)
    assert isinstance(ds, NumpyPathDataset) and ds.shape == (1, 4, 4)
    common = ["--latent_dim", "16", "--network_size", "xxs", "--base_batch_size", "4",
              "--mixing_nimg", "4", "--stabilizing_nimg", "4", "--noise_stddev", "0",
              "--g_lr", "1e-3", "--d_lr", "1e-3", "--loss_fn", "wgan",
              "--conv_kernel_size", "3", "3", "--disable_grad_histograms", "--device", "cpu",
              "--starting_phase", "1", "--ending_phase", "2"]
    cli_main(["pgan", jpegs, "--start_shape", "(3, 4, 4)", "--final_shape", "(3, 16, 16)",
              "--logdir", str(tmp_path / "cli_jpeg"), "--use_pallas_fusion", *common])
    cli_main(["pgan", str(npy), "--start_shape", "(1, 4, 4)", "--final_shape", "(1, 16, 16)",
              "--logdir", str(tmp_path / "cli_npy"), *common])
    for logdir, channels, pipeline in (("cli_jpeg", 3, "python_thread"),
                                       ("cli_npy", 1, "native")):
        params, _, _ = ckpt.load_params(str(tmp_path / logdir / "model_2.npz"), "cpu")
        assert all(torch.isfinite(v).all() for v in params.values())
        rgb = [v for k, v in params.items() if k.startswith("generator/") and
               v.ndim == 4 and v.shape[:2] == (1, 1)]
        assert rgb and all(v.shape[-1] == channels for v in rgb)
        ev = _events(tmp_path / logdir)
        assert {e["text"] for e in ev if e["tag"] == "config/input_pipeline"} == {pipeline}
        assert all(np.isfinite(e["value"]) for e in ev if e["tag"] == "Loss/d_loss")


# ---------------------------------------------------------------------------
# Serving a 2-D checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rgb_checkpoint(tmp_path_factory):
    """A phase-2 RGB pgan checkpoint written by the JAX package."""
    kw = dict(architecture="pgan", start_shape="(3, 4, 4)", final_shape="(3, 16, 16)",
              starting_phase=2, ending_phase=2, latent_dim=16, network_size="xxs")
    params = jax_arch("pgan").init(jax.random.PRNGKey(0), phase=2,
                                   cfg=JaxConfig(**kw).finalize())
    path = str(tmp_path_factory.mktemp("serve2d") / "model_2")
    jax_ckpt.save_params(path, params, ema=dict(params), meta={"phase": 2})
    return path + ".npz", Config(**kw).finalize()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers.get("Content-Type"), r.read()


def test_serve_2d_images_over_http(rgb_checkpoint):
    path, cfg = rgb_checkpoint
    service = GeneratorService.from_checkpoint("pgan", path, cfg=cfg, phase=2, batch_size=4,
                                               device="cpu")
    srv = make_server(service, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/generate"
    try:
        calls = fba.bias_act_pixelnorm_plain.calls
        results = {}

        def request(seed, n):
            results[seed] = np.load(io.BytesIO(_post(url, {"num_samples": n, "seed": seed,
                                                           "unnormalize": False})[1]))

        threads = [threading.Thread(target=request, args=(s, n))
                   for s, n in ((1, 1), (2, 3), (3, 4), (4, 4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert fba.bias_act_pixelnorm_plain.calls > calls  # serving forces #4 on
        for seed, n in ((1, 1), (2, 3), (3, 4), (4, 4)):
            imgs = results[seed]
            assert imgs.shape == (n, 3, 8, 8) and imgs.dtype == np.float32
            assert np.isfinite(imgs).all()
            np.testing.assert_array_equal(imgs, service.generate(n, seed=seed))
        ctype, png = _post(url, {"num_samples": 3, "format": "png"})
        assert ctype == "image/png"
        assert Image.open(io.BytesIO(png)).size == (3 * 8, 8)
    finally:
        srv.shutdown()
        service.close()


def test_generate_minimal_2d(rgb_checkpoint, tmp_path):
    path, _ = rgb_checkpoint
    generate_main(["pgan", "unused", path, str(tmp_path / "out"), "--minimal",
                   "--num_samples", "2", "--phase", "2", "--latent_dim", "16",
                   "--start_shape", "(3, 4, 4)", "--final_shape", "(3, 16, 16)",
                   "--network_size", "xxs", "--device", "cpu"])
    imgs = [np.load(p) for p in sorted((tmp_path / "out").iterdir())]
    # channel 0 of each image, as the reference dumps (its generate_minimal keeps vol[0])
    assert len(imgs) == 2 and all(i.shape == (8, 8) and np.isfinite(i).all()
                                  for i in imgs)


# ---------------------------------------------------------------------------
# --calc_metrics in 2-D
# ---------------------------------------------------------------------------


class _Phase:
    """What a metric callback reads of its trainer."""
    phase = 1
    global_size = 1
    verbose = False
    writer = None


@pytest.mark.parametrize("metric", ["compute_FID", "compute_swds", "compute_ssims",
                                    "compute_psnrs", "compute_mses", "compute_nrmses"])
def test_calc_metrics_2d_does_what_the_reference_does(tmp_path, metric, jax_native):  # noqa: F811
    """Both callbacks on the same 16x16 RGB real batches (libjpeg on both sides) and the
    same fakes: the same error where the reference raises, else the same dict."""
    jpegs = make_jpegs(tmp_path / "imagenet", n=12)
    kw = trainer_kw(jpegs, start_shape="(3, 16, 16)", final_shape="(3, 32, 32)",
                    ending_phase=1, calc_metrics=True, allow_uncalibrated_fid=True, **{metric: True})
    jcfg, cfg = JaxConfig(**kw).finalize(), Config(**kw).finalize()
    fakes = np.random.default_rng(0).normal(size=(4, 3, 16, 16)).astype(np.float32)
    from saragan_tpu.metrics.fid import RandomConvFeatures as JaxRandomFeatures

    ref_cb = jax_metrics_callback(jcfg, extractor=JaxRandomFeatures(out_dim=32)
                                  if metric == "compute_FID" else None)
    our_cb = make_metrics_callback(cfg, extractor=RandomConvFeatures(out_dim=32, device="cpu")
                                   if metric == "compute_FID" else None)
    ref_ds = jax_imagenet_factory(jcfg, jpegs)(1)
    from saragan_tpu_torch.data.imagenet import imagenet_dataset_factory

    our_ds = imagenet_dataset_factory(cfg, jpegs)(1)

    def run(cb, ds):
        try:
            return cb(_Phase(), lambda k, n: fakes[:n], ds, 0, ""), None
        except Exception as e:  # noqa: BLE001 - the error itself is what is compared
            return None, e

    ref, ref_err = run(ref_cb, ref_ds)
    ours, our_err = run(our_cb, our_ds)
    if ref_err is not None:
        # the reference computes FID and SWD on volumes only and raises: the port raises
        # the same message, as the same type or a subclass (FID: ValueError for Exception)
        assert metric in ("compute_FID", "compute_swds")
        assert isinstance(our_err, type(ref_err)) and str(our_err) == str(ref_err), our_err
    else:
        assert our_err is None, our_err
        assert ours.keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_allclose(ours[k], v, rtol=1e-5, err_msg=k)
        assert (ours == {}) == (metric == "compute_ssims")
