"""The memory levers of the big-volume phases against the port's plain step and the JAX
package's step: ``remat`` (G and D one recompute region each), ``remat_offload`` (the
block taps parked in host memory, everything else recomputed) and the
``single_chip_big_volume`` preset; the block taps' names against the reference's
``checkpoint_name`` tags; the preset trainer end to end at phase 2; and the kernels'
plans at every conv, wgrad and fused shape of the preset's step at phases 7 and 8.

Recompute runs the same functions on the same inputs, so every lever is bit-equal to the
plain step with the same model flags.  Against the reference the tolerances are those of
``tests/test_torch_train_step.py`` (f32 losses rtol 1e-4, parameters rtol 1e-3)."""

import dataclasses
import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import saragan_tpu.ops.core as jax_ops_core
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.models.common import offload_block_names as jax_offload_block_names
from saragan_tpu.train import init_train_state as jax_init_train_state
from saragan_tpu.train import make_train_step as jax_make_train_step
from saragan_tpu_torch import losses
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import train_state_from_numpy, train_state_to_numpy
from saragan_tpu_torch.models import common, get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import conv3d_grad as cg
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.optim.factory import make_optimizers_from_config
from saragan_tpu_torch.tools import profile_training
from saragan_tpu_torch.train.step import init_train_state, make_train_step
from test_torch_train_step import _tree, jax_draws

torch.set_num_threads(1)

# the reference's tiny_cfg (tests/test_losses_and_step.py:16-32): phase 2 is 8^3, batch 4
TINY = dict(architecture="pgan", start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)",
            latent_dim=16, base_batch_size=4,
            kernel_spec=[[[], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
            filter_spec=[[8, 8], [8, 8], [4, 4]], loss_fn="wgan", gp_weight=1.0,
            noise_stddev=0.0, g_lr=1e-3, d_lr=1e-3, use_pallas_fusion=True)
PHASE, N = 2, 4
LEVERS = {"remat": dict(remat=True), "remat_offload": dict(remat_offload=True),
          "preset": dict(single_chip_big_volume=True)}
# the model flags a lever runs with, so that its plain twin differs only by the lever
PRESET_FLAGS = dict(batched_passes=False, fused_transitions=False)


@pytest.fixture(autouse=True)
def jax_direct_engine(monkeypatch):
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", "direct")


def _real(seed=0, n=N, phase=PHASE):
    shape = Config(**TINY).finalize().current_shape(phase, n)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_step(cfg, state, real, alpha, steps=1, seed=3):
    go, do = make_optimizers_from_config(cfg)
    step = make_train_step(get_architecture("pgan"), cfg, PHASE, go, do, conv_engine="flat")
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        state, m = step(state, torch.from_numpy(real), gen, alpha, 1e-3, 1e-3)
    return state, m, step


def _assert_bit_equal(a, b):
    for part in ("g_params", "d_params", "ema"):
        pa, pb = getattr(a, part), getattr(b, part)
        assert pa.keys() == pb.keys()
        for k in pa:
            assert torch.equal(pa[k], pb[k]), (part, k)
    for part in ("g_opt", "d_opt"):
        for k in getattr(a, part).mu:
            assert torch.equal(getattr(a, part).mu[k], getattr(b, part).mu[k]), (part, k)
            assert torch.equal(getattr(a, part).nu[k], getattr(b, part).nu[k]), (part, k)


@pytest.mark.parametrize("alpha", [0.5, 0.0], ids=["mixing", "stabilizing"])
@pytest.mark.parametrize("lever", list(LEVERS))
def test_lever_step_is_bit_equal_to_the_plain_step(lever, alpha):
    """Two steps under the lever against two plain steps with the same model flags, from
    one state and the same draws: every parameter, Adam slot, EMA entry and loss bit for
    bit (the penalty's grad-of-grad runs through the recompute regions)."""
    flags = PRESET_FLAGS if lever == "preset" else {}
    cfg = Config(**TINY, **LEVERS[lever]).finalize()
    plain = Config(**TINY, **flags).finalize()
    assert (cfg.batched_passes, cfg.fused_transitions) == (plain.batched_passes,
                                                           plain.fused_transitions)
    state0, _ = init_train_state(get_architecture("pgan"), torch.Generator().manual_seed(0),
                                 phase=PHASE, cfg=plain, device="cpu")
    real = _real()
    a, ma, step = _port_step(cfg, state0, real, alpha, steps=2)
    b, mb, _ = _port_step(plain, state0, real, alpha, steps=2)
    _assert_bit_equal(a, b)
    for x, y in zip(ma[:5], mb[:5]):
        assert torch.equal(x, y)
    assert (step.parked_bytes > 0) == cfg.remat_offload


@pytest.mark.parametrize("lever", list(LEVERS))
def test_lever_step_matches_the_reference_step(lever):
    """One step of the port under the lever against the reference's step with the same
    flags (``tests/test_losses_and_step.py:565``'s configuration), from one converted
    state, fed the reference's draws."""
    jcfg = JaxConfig(**TINY, **LEVERS[lever]).finalize()
    cfg = Config(**TINY, **LEVERS[lever]).finalize()
    jstate, (jgo, jdo) = jax_init_train_state(jax_arch("pgan"), jax.random.PRNGKey(0),
                                              phase=PHASE, cfg=jcfg)
    jstep = jax.jit(jax_make_train_step(jax_arch("pgan"), jcfg, PHASE, jgo, jdo))
    real, key = _real(seed=1), jax.random.PRNGKey(7)
    jstate, jm = jstep(jstate, jnp.asarray(real), key, 0.5, 1e-3, 1e-3)
    go, do = make_optimizers_from_config(cfg)
    step = make_train_step(get_architecture("pgan"), cfg, PHASE, go, do, conv_engine="flat")
    tstate = train_state_from_numpy(_tree(jax_init_train_state(
        jax_arch("pgan"), jax.random.PRNGKey(0), phase=PHASE, cfg=jcfg)[0]), "cpu")
    draws = jax_draws(key, N, cfg.latent_dim, real.shape[1:], jnp.float32)
    tstate, m = step(tstate, torch.from_numpy(real), None, 0.5, 1e-3, 1e-3, draws=draws)
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        np.testing.assert_allclose(float(getattr(m, name)), float(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    ours, ref = train_state_to_numpy(tstate), _tree(jstate)
    for part in ("g_params", "d_params", "ema"):
        for k, v in ref[part].items():
            np.testing.assert_allclose(ours[part][k], v, rtol=1e-3, atol=1e-6, err_msg=k)


def _expected_taps(phase, batched):
    """The taps one step keeps: G's once, D's once per first-order critic pass (the fake
    and the real pass, or one stacked pass); the penalty's D keeps none."""
    gen = ["gen_in"] + [t for i in range(2, phase + 1) for t in (f"gen_block_{i}_mid",
                                                                 f"gen_block_{i}")]
    disc = ["disc_in"] + [t for i in range(phase, 1, -1) for t in (f"disc_block_{i}_mid",
                                                                   f"disc_block_{i}")]
    return Counter(gen + disc * (1 if batched else 2))


@pytest.mark.parametrize("batched", [True, False], ids=["stacked_critic", "two_passes"])
@pytest.mark.parametrize("phase", [2, 3])
def test_offload_parks_exactly_the_block_taps(monkeypatch, phase, batched):
    """Under remat_offload a saved-tensor hook sees every tensor autograd keeps outside
    the recompute regions: the block taps are parked in host memory, once each, and
    nothing else is; their bytes are what the step reports."""
    cfg = Config(**TINY, remat_offload=True, batched_passes=batched).finalize()
    packed = []
    hooks = torch.autograd.graph.saved_tensors_hooks

    def spy(pack, unpack):
        def pack_spy(t):
            out = pack(t)
            if isinstance(out, tuple):  # parked: once per tap, however often it is kept
                packed.append((t.block_tap, tuple(t.shape), out[1]))
                assert out[1].device.type == "cpu" and torch.equal(out[1], t.detach())
            return out
        return hooks(pack_spy, unpack)

    monkeypatch.setattr(torch.autograd.graph, "saved_tensors_hooks", spy)
    state, _ = init_train_state(get_architecture("pgan"), torch.Generator().manual_seed(0),
                                phase=phase, cfg=cfg, device="cpu")
    go, do = make_optimizers_from_config(cfg)
    step = make_train_step(get_architecture("pgan"), cfg, phase, go, do, conv_engine="flat")
    real = torch.from_numpy(_real(seed=2, phase=phase))
    step(state, real, torch.Generator().manual_seed(1), 0.5, 1e-3, 1e-3)
    copies = {id(host): (name, shape) for name, shape, host in packed}  # all still alive
    assert Counter(name for name, _ in copies.values()) == _expected_taps(phase, batched)
    elems = sum(math.prod(s) for _, s in copies.values())
    assert step.parked_bytes == elems * 4


def _reference_tap_names(fn, *args):
    """The names the reference's models tag with ``checkpoint_name`` in one traced call."""
    names = []

    def walk(j):
        for e in j.eqns:
            if e.primitive.name == "name":
                names.append(e.params["name"])
            for p in e.params.values():
                for q in (p if isinstance(p, (list, tuple)) else [p]):
                    if isinstance(q, jax.extend.core.ClosedJaxpr):
                        walk(q.jaxpr)
                    elif isinstance(q, jax.extend.core.Jaxpr):
                        walk(q)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return names


@pytest.mark.parametrize("fused_transitions", [True, False])
@pytest.mark.parametrize("alpha", [0.5, 0.0])
@pytest.mark.parametrize("phase", [1, 2, 3])
def test_models_emit_the_reference_tap_names(monkeypatch, phase, alpha, fused_transitions):
    """G and D mark the same block boundaries, in the same order, as the reference's
    models tag at every phase, and offload_block_names is the reference's."""
    kw = dict(TINY, remat_offload=True, fused_transitions=fused_transitions)
    jcfg, cfg = JaxConfig(**kw).finalize(), Config(**kw).finalize()
    assert common.offload_block_names(phase) == jax_offload_block_names(phase)
    params = jax_arch("pgan").init(jax.random.PRNGKey(0), phase=phase, cfg=jcfg)
    z = jnp.zeros((2, cfg.latent_dim))
    x = jnp.zeros(cfg.current_shape(phase, 2))
    ref_g = _reference_tap_names(lambda p, z: jax_arch("pgan").generator(
        p, z, alpha, phase=phase, cfg=jcfg), params, z)
    ref_d = _reference_tap_names(lambda p, x: jax_arch("pgan").discriminator(
        p, x, alpha, phase=phase, cfg=jcfg), params, x)
    seen = []
    tap = common.block_tap

    def spy(t, name, c):
        seen.append(name)
        return tap(t, name, c)

    monkeypatch.setattr("saragan_tpu_torch.models.pgan.block_tap", spy)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    arch = get_architecture("pgan")
    with torch.no_grad():
        arch.generator(tparams, torch.zeros(2, cfg.latent_dim), alpha, phase=phase, cfg=cfg)
        port_g, seen[:] = list(seen), []
        arch.discriminator(tparams, torch.zeros(cfg.current_shape(phase, 2)), alpha,
                           phase=phase, cfg=cfg)
    assert port_g == ref_g and seen == ref_d
    assert set(ref_g + ref_d) <= set(common.offload_block_names(phase))


def test_segment_is_a_plain_call_without_the_lever():
    cfg = Config(**TINY).finalize()
    x = torch.ones(3, requires_grad=True)
    y = common.segment(lambda t: t * 2, cfg, x)
    assert y.grad_fn.name() == "MulBackward0"
    assert common.block_tap(y, "gen_in", cfg) is y and not hasattr(y, "block_tap")


def test_preset_trainer_end_to_end(tmp_path):
    """The counterpart of ``tests/test_trainer.py:219``: ``--single_chip_big_volume``
    trains phase 2 through the CLI on the CPU under the flat engine (its kernels' plain
    versions) and writes finite parameters and a summary event."""
    import json

    from saragan_tpu_torch import cli

    rng = np.random.default_rng(0)
    for size in (4, 8):  # phases 1 and 2 of 4^3 -> 16^3
        d = tmp_path / "data" / f"{size}x{size}"
        d.mkdir(parents=True)
        for i in range(8):
            np.save(d / f"v{i}.npy", rng.normal(size=(size, size, size)).astype(np.float32))
    calls = cf.conv3d_flat_plain.calls
    cli.main(["pgan", str(tmp_path / "data"), "--start_shape", "(1, 4, 4, 4)",
              "--final_shape", "(1, 16, 16, 16)", "--starting_phase", "2", "--ending_phase", "2",
              "--latent_dim", "16", "--network_size", "xs", "--base_batch_size", "4",
              "--mixing_nimg", "4", "--stabilizing_nimg", "4", "--noise_stddev", "0",
              "--g_lr", "1e-3", "--d_lr", "1e-3", "--loss_fn", "wgan",
              "--single_chip_big_volume", "--use_pallas_fusion",
              "--summary_small_every_nsteps", "2", "--summary_large_every_nsteps", "4",
              "--logdir", str(tmp_path / "run"), "--device", "cpu"])
    assert cf.conv3d_flat_plain.calls > calls  # flat, resolved by the preset on the CPU
    from saragan_tpu_torch.train import checkpoint as ckpt

    params, _, _ = ckpt.load_params(str(tmp_path / "run" / "model_2.npz"), "cpu")
    assert params and all(torch.isfinite(v).all() for v in params.values())
    with open(tmp_path / "run" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["text"] for e in events if e["tag"] == "config/conv_engine"] == ["flat"]
    assert any(e["tag"] == "Loss/d_loss" for e in events)


# ---------------------------------------------------------------------------
# The kernels' plans at the preset step's phase-7 and phase-8 shapes
# ---------------------------------------------------------------------------


def _preset_step_shapes(phase, batch, monkeypatch):
    """Every conv (x, w), wgrad (x, dy, kernel) and fused (x shape) one preset step
    launches, from a run on the meta device."""
    convs, wgrads, fused = Counter(), Counter(), Counter()
    conv, wgrad, fplain = cg.conv3d_flat, cg.conv3d_flat_wgrad, fba.bias_act_pixelnorm_plain

    def conv_spy(x, w, role="forward"):
        convs[(tuple(x.shape), tuple(w.shape))] += 1
        return conv(x, w, role)

    def wgrad_spy(x, dy, kernel):
        wgrads[(tuple(x.shape), tuple(dy.shape), tuple(kernel))] += 1
        return wgrad(x, dy, kernel)

    def fused_spy(x, *args, **kw):
        fused[tuple(x.shape)] += 1
        return fplain(x, *args, **kw)

    fused_spy.calls = 0  # the plain version counts its calls under its module name

    monkeypatch.setattr(cg, "conv3d_flat", conv_spy)
    monkeypatch.setattr(cg, "conv3d_flat_wgrad", wgrad_spy)
    monkeypatch.setattr(fba, "bias_act_pixelnorm_plain", fused_spy)
    cfg = profile_training.bench_train_config(phase, batch, single_chip_big_volume=True)
    # the recompute regions need autograd's saved tensors, which the meta device has; the
    # shapes are those of the plain step with the preset's model flags
    cfg = dataclasses.replace(cfg, remat_offload=False)
    arch = get_architecture("pgan")
    state, (go, do) = init_train_state(arch, torch.Generator().manual_seed(0), phase=phase,
                                       cfg=cfg, device="meta")
    real = torch.empty(cfg.current_shape(phase, batch), device="meta")
    draws = losses.draw_inputs(None, batch, cfg.latent_dim, real.shape[1:], torch.float32,
                               "meta")
    make_train_step(arch, cfg, phase, go, do, conv_engine="flat")(
        state, real, None, 0.5, 1e-3, 1e-3, draws=draws)
    return convs, wgrads, fused


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("phase", [7, 8])
def test_plans_fit_every_big_volume_shape(phase, batch, monkeypatch):
    """Every forward, dgrad, wgrad and fused shape of the preset's step at phases 7 and 8
    (C = 8 at 64x256x256 and 128x512x512) gets a tensor-core and a CUDA-core plan within
    shared memory and the grid's limits, at batch 1 and at batch 8, where N * C * D * H * W
    reaches 2^31 at phase 8: every kernel forms element offsets in 64 bits at every size,
    so no separate path is chosen there."""
    convs, wgrads, fused = _preset_step_shapes(phase, batch, monkeypatch)
    assert convs and wgrads and fused
    biggest = 0
    for xs, ws in convs:
        p = cf.conv_tc_plan(xs, ws)
        assert p.smem <= cf.MAX_SMEM and p.blocks < 2 ** 31 and p.f_tiles <= 65535
        assert p.cc == 16 or xs[1] > 16  # C = 8 is padded to one 16-channel chunk
        q = cf.conv_simt_plan(xs, ws)
        assert q.smem <= cf.MAX_SMEM
        biggest = max(biggest, math.prod(xs), xs[0] * ws[-1] * math.prod(xs[2:]))
    for xs, dys, k in wgrads:
        p = cf.wgrad_tc_plan(xs, dys, k)
        assert p.smem <= cf.MAX_SMEM and p.splits < 2 ** 31
        assert cf.wgrad_simt_plan(xs, dys, k).smem <= cf.MAX_SMEM
    for shape in fused:
        n, c = shape[:2]
        for dtype in (torch.bfloat16, torch.float32):
            for backward in (False, True):
                p = fba.fused_plan(c, math.prod(shape[2:]), dtype, cf.H100_SMS, backward=backward)
                assert p.smem <= fba.MAX_SMEM and n * p.tiles < 2 ** 31
    full = cf.conv_tc_plan((1, 8, 128, 512, 512), (3, 3, 3, 8, 8))
    assert (phase, batch) != (8, 8) or biggest >= 2 ** 31
    assert full.cc == 16
