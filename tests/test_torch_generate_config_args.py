"""``tools/generate.py::main --config_args`` (the repair of ROADMAP.md queue 3's fault): a
surfgan checkpoint the JAX package wrote with ``--first_conv_nfilters 64`` (not the
table's 16) is sampled through the port's generate CLI, with the whole training command
line after ``--config_args`` (the reference's form) and with only the flag that differs
(generate's own model flags as the defaults).  Every generator name of the checkpoint
must be the port's for that Config (a strict load), the Config fields must equal the
reference CLI's from the same argv, and the port's generator on a fixed z must match the
JAX one within the families' f32 tolerance (1e-5 of max|ref|, tests/test_torch_families.py).
surfgan's init gives every noise strength 0, so the per-layer noise the two packages
draw differently adds nothing here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saragan_tpu import cli as jax_cli
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.train import checkpoint as jax_ckpt
from saragan_tpu_torch.convert import params_from_numpy
from saragan_tpu_torch.core import filter_params
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.tools import generate
from saragan_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

PHASE = 2
CONFIG_ARGS = ["--start_shape", "(1, 4, 4, 4)", "--final_shape", "(1, 16, 16, 16)",
               "--starting_phase", str(PHASE), "--ending_phase", str(PHASE), "--latent_dim",
               "16", "--network_size", "xxs", "--noise_stddev", "0",
               "--first_conv_nfilters", "64"]
# the generator-shaping fields: what the families read to build G, and the shapes
SHAPING = ("architecture", "start_shape", "final_shape", "latent_dim", "network_size",
           "first_conv_nfilters", "num_labels", "activation", "leakiness",
           "conv_kernel_size", "kernel_spec", "filter_spec", "fused_transitions",
           "use_pallas_fusion", "starting_phase", "ending_phase", "data_mean", "data_stddev")


def _reference(tmp_path, config_args, phase):
    """The reference CLI's Config from `config_args` (its generate's path) and a
    checkpoint of its surfgan init at `phase`."""
    args = jax_cli.build_parser().parse_args(["surfgan", str(tmp_path)] + config_args)
    jcfg = jax_cli.config_from_args(args).finalize()
    params = jax_arch("surfgan").init(jax.random.PRNGKey(0), phase=phase, cfg=jcfg)
    path = jax_ckpt.save_params(str(tmp_path / f"model_{phase}"), params, ema=params)
    return jcfg, {k: np.asarray(v) for k, v in params.items()}, path


def _main(monkeypatch, argv):
    """generate.main(argv); returns the Config it sampled with."""
    seen = []
    real = generate.config_from_cli
    monkeypatch.setattr(generate, "config_from_cli",
                        lambda args: seen.append(real(args)) or seen[0])
    generate.main(argv)
    return seen[0]


@pytest.mark.parametrize("form", ["whole", "only_the_difference"])
def test_generate_config_args_samples_a_jax_checkpoint(tmp_path, monkeypatch, form):
    jcfg, jparams, path = _reference(tmp_path, CONFIG_ARGS, PHASE)
    assert jcfg.first_conv_nfilters == 64
    assert all(float(np.abs(v).max()) == 0 for k, v in jparams.items()
               if k.endswith("noise_strength"))
    out = tmp_path / "out"
    argv = ["surfgan", str(tmp_path), path, str(out), "--phase", str(PHASE), "--minimal",
            "--num_samples", "2", "--device", "cpu"]
    if form == "whole":
        argv += ["--config_args", *CONFIG_ARGS]
    else:  # generate's own model flags, then only the flag that shapes G differently
        argv += ["--start_shape", "(1, 4, 4, 4)", "--final_shape", "(1, 16, 16, 16)",
                 "--latent_dim", "16", "--network_size", "xxs",
                 "--config_args", "--first_conv_nfilters", "64"]
    cfg = _main(monkeypatch, argv)
    for name in SHAPING:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.resolved_kernel_spec() == jcfg.resolved_kernel_spec()
    assert cfg.resolved_filter_spec() == jcfg.resolved_filter_spec()
    vols = [np.load(out / f"fake_{i:04d}.npy") for i in range(2)]
    assert all(v.shape == (8, 8, 8) and np.isfinite(v).all() for v in vols)

    # a strict load: the checkpoint's generator names are exactly the port's for cfg
    init = get_architecture("surfgan").init(torch.Generator().manual_seed(0), phase=PHASE,
                                            cfg=cfg, device="meta")
    g_ckpt, _ = generate._load_generator_params(path, True, "cpu")
    g_init = filter_params(init, "generator")
    assert g_ckpt.keys() == g_init.keys()
    assert all(g_ckpt[k].shape == v.shape for k, v in g_init.items())
    ckpt.restore_into(g_init, g_ckpt, strict=True)

    # the port's generator on a fixed z against the reference's
    z = np.random.default_rng(1).normal(size=(2, 16)).astype(np.float32)
    ref = np.asarray(jax_arch("surfgan").generator(
        {k: jnp.asarray(v) for k, v in jparams.items() if k.startswith("generator")},
        jnp.asarray(z), 0.0, phase=PHASE, cfg=jcfg, rng=jax.random.PRNGKey(3), train=False))
    ours = get_architecture("surfgan").generator(
        params_from_numpy({k: v for k, v in jparams.items() if k.startswith("generator")},
                          "cpu"), torch.from_numpy(z), 0.0, phase=PHASE, cfg=cfg,
        conv_engine="direct", train=False)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_generate_without_config_args_keeps_its_model_flags():
    """No --config_args: the fixed flags build the Config as before the repair."""
    args = dict(architecture="pgan", start_shape="(1, 1, 4, 4)",
                final_shape="(1, 128, 512, 512)", latent_dim=256, network_size="xs", phase=3,
                data_mean=None, data_stddev=None, config_args=[])
    cfg = generate.config_from_cli(type("Args", (), args))
    assert cfg == generate.config_from_args(type("Args", (), args))
    assert (cfg.starting_phase, cfg.ending_phase, cfg.first_conv_nfilters) == (3, 3, None)


def test_the_short_command_form_samples_at_the_default_model_flags(tmp_path, monkeypatch):
    """``main([arch, data, model, out, '--phase', '3', '--config_args',
    '--first_conv_nfilters', '64'])`` at generate's default model flags (the flagship's
    shapes: start (1, 1, 4, 4), latent 256, 'xs') samples the JAX-written checkpoint."""
    jcfg, _, path = _reference(tmp_path, [
        "--start_shape", "(1, 1, 4, 4)", "--final_shape", "(1, 128, 512, 512)",
        "--starting_phase", "3", "--ending_phase", "3", "--latent_dim", "256",
        "--network_size", "xs", "--noise_stddev", "0", "--first_conv_nfilters", "64"], 3)
    out = tmp_path / "out3"
    cfg = _main(monkeypatch, ["surfgan", str(tmp_path), path, str(out), "--phase", "3",
                              "--minimal", "--num_samples", "1", "--device", "cpu",
                              "--config_args", "--first_conv_nfilters", "64"])
    for name in SHAPING:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    vol = np.load(out / "fake_0000.npy")
    assert vol.shape == (4, 16, 16) and np.isfinite(vol).all()
