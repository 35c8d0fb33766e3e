"""The benchmark's plain reference against the port, on the CPU at tiny sizes, in float32:
G and D forward, two train steps (the mixing step with the previous phase's names frozen,
then the stabilizing step).  Also the reference's transition conv:
its first and second derivatives against autograd of the plain upscale and conv."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import compare
from portbench.drivers import train_step
from portbench.reference import ops as rops
from portbench.reference import train as rt
from portbench.reference.ops import Params

from conftest import REPO, tiny_config

PHASE, BATCH = 3, 4


def _setup(name):
    conf = tiny_config(name)["config"]
    cfg = dataclasses.replace(train_step.port_config(conf, PHASE), compute_dtype="float32")
    ref_cfg = rt.model_cfg(conf)
    return cfg, ref_cfg


@pytest.mark.parametrize("name", ["pgan_xs", "surfgan"])
def test_parameters_and_filters_match(name):
    from saragan_tpu_torch.models import get_architecture
    from saragan_tpu_torch.models.common import phase_filters

    cfg, ref_cfg = _setup(name)
    port = get_architecture(cfg.architecture).init(torch.Generator().manual_seed(0),
                                                   phase=PHASE, cfg=cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in port.items()} == rt.param_shapes(ref_cfg, PHASE)
    if name == "surfgan":  # the family sizes its filters from the tables, as the spec says
        assert [phase_filters(cfg, i) for i in range(1, PHASE + 1)] == [
            f[0] for f in ref_cfg["filter_spec"][:PHASE]]
    from saragan_tpu_torch.config import Config

    full = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())["config"]
    c = Config(**{k: v for k, v in full.items()
                  if k not in ("kernel_spec", "filter_spec")}).finalize()
    assert c.resolved_kernel_spec() == full["kernel_spec"]
    assert c.resolved_filter_spec() == full["filter_spec"]


@pytest.mark.parametrize("name", ["pgan_xs", "surfgan"])
def test_two_train_steps_match_the_port(name):
    from saragan_tpu_torch.models import get_architecture
    from saragan_tpu_torch.optim.ema import ema_init
    from saragan_tpu_torch.optim.factory import make_optimizers_from_config
    from saragan_tpu_torch.optim.freeze import apply_freeze_names
    from saragan_tpu_torch.train.step import TrainState, make_train_step

    cfg, ref_cfg = _setup(name)
    arch = get_architecture(cfg.architecture)
    params = train_step.make_weights(rt.param_shapes(ref_cfg, PHASE), 3, "cpu")
    theta0 = {k: v.clone() for k, v in params.items()}
    g_opt, d_opt = make_optimizers_from_config(cfg)
    g = {k: v for k, v in params.items() if k.startswith("generator/")}
    d = {k: v for k, v in params.items() if k.startswith("discriminator/")}
    state = TrainState(g, d, g_opt.init(g), d_opt.init(d), ema_init(params))
    prev = arch.init(torch.Generator().manual_seed(0), phase=PHASE - 1, cfg=cfg, device="meta")
    frozen = apply_freeze_names(params, prev)
    assert frozen == rt.frozen_names(ref_cfg, PHASE)
    steps = [(make_train_step(arch, cfg, PHASE, g_opt, d_opt, frozen_names=frozen, freeze=True,
                              conv_engine="direct"), 0.5, frozen),
             (make_train_step(arch, cfg, PHASE, g_opt, d_opt, static_alpha=0.0,
                              conv_engine="direct"), 0.0, frozenset())]
    inputs = train_step.make_inputs(ref_cfg, cfg, PHASE, BATCH, 2, torch.float32, 5, "cpu")
    ref = rt.init_state(params)
    for (fn, alpha, fr), (real, draws) in zip(steps, inputs):
        state, m = fn(state, real, None, alpha, cfg.g_lr, cfg.d_lr,
                      draws=train_step.port_draws(draws))
        ref, losses, _ = rt.step(ref, real, draws, torch.tensor(alpha) if fr else 0.0,
                                 cfg=ref_cfg, phase=PHASE, frozen=fr)
        np.testing.assert_allclose([float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)],
                                   losses, rtol=1e-4, atol=1e-5)
    prog = {**state.g_params, **state.d_params}
    names = sorted(prog)

    def norms(tree, base=None):
        return {k: compare._norm(tree[k] - (0 if base is None else base[k])) for k in names}

    for p, r in ((norms(prog, theta0), norms(ref.params, theta0)),
                 (norms(state.ema, theta0), norms(ref.ema, theta0)),
                 (norms({**state.g_opt.mu, **state.d_opt.mu}), norms(ref.mu)),
                 (norms({**state.g_opt.nu, **state.d_opt.nu}), norms(ref.nu))):
        assert max(compare.leaf_gaps(p, r, names)) < 1e-4


@pytest.mark.parametrize("kernel", [(3, 3, 3), (1, 3, 3), (1, 1, 1)])
@pytest.mark.parametrize("rows", [None, 1])
def test_transition_gradients(kernel, rows, monkeypatch):
    if rows:  # one row a chunk, as for operands past the 64-bit-index size
        monkeypatch.setattr(rops, "INDEX_LIMIT", 1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 3, 2, 3, 2), generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((*kernel, 3, 2), generator=g, dtype=torch.float64, requires_grad=True)

    def plain(x, w):
        return torch.nn.functional.conv3d(rops.upscale(x), w.permute(4, 3, 0, 1, 2),
                                          padding=[k // 2 for k in kernel])

    torch.testing.assert_close(rops.upconv(x, w), plain(x, w))
    assert torch.autograd.gradcheck(rops.upconv, (x, w))
    assert torch.autograd.gradgradcheck(rops.upconv, (x, w))


def test_generator_forward_matches_the_port():
    from saragan_tpu_torch.models import get_architecture

    for name in ("pgan_xs", "surfgan"):
        cfg, ref_cfg = _setup(name)
        arch = get_architecture(cfg.architecture)
        params = train_step.make_weights(rt.param_shapes(ref_cfg, PHASE), 4, "cpu")
        z = torch.randn(BATCH, cfg.latent_dim, generator=torch.Generator().manual_seed(2))
        for alpha in (0.0, 0.3):
            a = alpha if alpha == 0.0 else torch.tensor(alpha)
            yp = arch.generator(params, z, a, phase=PHASE, cfg=cfg, conv_engine="direct",
                                train=False)
            yr = rt.ARCHS[cfg.architecture].generator(Params(params), z, a, phase=PHASE,
                                                      cfg=ref_cfg)
            assert float((yp - yr).abs().max() / yr.abs().max()) < 1e-5
            dp = arch.discriminator(params, yp, a, phase=PHASE, cfg=cfg, conv_engine="direct")
            dr = rt.ARCHS[cfg.architecture].discriminator(Params(params), yp, a, phase=PHASE,
                                                          cfg=ref_cfg)
            torch.testing.assert_close(dp, dr, rtol=1e-5, atol=1e-6)
