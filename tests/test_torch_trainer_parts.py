"""The trainer's parts in the port against the JAX package: the LR schedule, freezing,
the EMA fold, one train step with frozen names and gradient histograms, the dataset's
shuffle stream and splits, the trainer's config defaults and conv-engine resolution,
checkpoint names, pruning and auto-resume.

The step is the phase-2 step of a tiny pgan fed the reference's own draws, from one
converted state (tolerances as in ``tests/test_torch_train_step.py``: parameters rtol
1e-3, atol 1e-6)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import saragan_tpu.ops.core as jax_ops_core
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.data.dataset import NumpyPathDataset as JaxDataset
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.optim import freeze as jax_freeze
from saragan_tpu.optim import schedules as jax_schedules
from saragan_tpu.optim.ema import fold_ema as jax_fold_ema
from saragan_tpu.train import checkpoint as jax_ckpt
from saragan_tpu.train import init_train_state as jax_init_train_state
from saragan_tpu.train import make_train_step as jax_make_train_step
from saragan_tpu_torch import losses
from saragan_tpu_torch.cli import build_parser, config_from_args
from saragan_tpu_torch.config import Config, resolve_conv_engine
from saragan_tpu_torch.convert import params_from_numpy, train_state_from_numpy
from saragan_tpu_torch.data.dataset import NumpyPathDataset
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.optim import freeze, schedules
from saragan_tpu_torch.optim.ema import fold_ema
from saragan_tpu_torch.optim.factory import AdamState, make_optimizers_from_config
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train.step import histogram, make_grads_fn, make_train_step
from saragan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# LR schedule
# ---------------------------------------------------------------------------

SCHEDULES = [(None, None), ("linear", None), ("exponential", None), (None, "linear"),
             (None, "exponential"), ("linear", "linear"), ("exponential", "exponential"),
             ("linear", "exponential")]


@pytest.mark.parametrize("increase,decrease", SCHEDULES)
def test_lr_schedule_equals_reference(increase, decrease):
    for steps_per_phase, rise, decay in ((1000, 300, 400), (64, 32, 32), (10, 10, 10)):
        for step in range(0, steps_per_phase + 1, max(1, steps_per_phase // 97)):
            args = (step, steps_per_phase, 1e-3, increase, decrease, rise, decay)
            assert schedules.lr_schedule(*args) == jax_schedules.lr_schedule(*args)


def test_scale_lr_equals_reference():
    for how in ("none", "sqrt", "linear"):
        for size in (1, 2, 8):
            args = (1e-3, 2e-3, how, "sqrt", size)
            assert schedules.scale_lr(*args) == jax_schedules.scale_lr(*args)
    with pytest.raises(ValueError):
        schedules.lr_schedule(1, 10, 1e-3, "cosine", None, 5, 5)


# ---------------------------------------------------------------------------
# Freezing and the EMA fold
# ---------------------------------------------------------------------------


def test_freeze_select_and_fold_ema_equal_reference():
    rng = np.random.default_rng(0)
    names = ["generator/a/weight", "generator/b/weight", "discriminator/c/bias"]
    old = {k: rng.normal(size=(3, 2)).astype(np.float32) for k in names}
    new = {k: rng.normal(size=(3, 2)).astype(np.float32) for k in names}
    prev = {"generator/a/weight": 0, "discriminator/c/bias": 0}
    frozen = freeze.apply_freeze_names(new, prev)
    assert frozen == jax_freeze.apply_freeze_names(new, prev) == frozenset(prev)
    ref = jax_freeze.freeze_select({k: jnp.asarray(v) for k, v in old.items()},
                                   {k: jnp.asarray(v) for k, v in new.items()}, frozen)
    ours = freeze.freeze_select(params_from_numpy(old, "cpu"), params_from_numpy(new, "cpu"),
                                frozen)
    for k in names:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    # the Adam state: moments selected per name, the count takes the new value
    s_old = AdamState(3, params_from_numpy(old, "cpu"), params_from_numpy(old, "cpu"))
    s_new = AdamState(4, params_from_numpy(new, "cpu"), params_from_numpy(new, "cpu"))
    sel = freeze.freeze_select(s_old, s_new, frozen)
    assert sel.count == 4
    for k in names:
        want = old[k] if k in frozen else new[k]
        np.testing.assert_array_equal(sel.mu[k].numpy(), want)
        np.testing.assert_array_equal(sel.nu[k].numpy(), want)
    assert freeze.freeze_select(s_old, s_new, frozenset()) is s_new

    folded = fold_ema(params_from_numpy(new, "cpu"), params_from_numpy(old, "cpu"))
    ref_f = jax_fold_ema(new, old)
    for k in names:
        np.testing.assert_array_equal(folded[k].numpy(), np.asarray(ref_f[k]))


# ---------------------------------------------------------------------------
# Histograms, and one step with frozen names and histograms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["normal", "constant", "edges", "tiny"])
def test_histogram_counts_equal_jnp_histogram(case):
    rng = np.random.default_rng(1)
    v = {"normal": rng.normal(size=(37, 29)) * 1e-3,
         "constant": np.full((50,), 0.25),
         # values on the edges of a range that linspace splits exactly
         "edges": np.concatenate([np.linspace(-1, 1, 65), np.linspace(-1, 1, 129)]),
         "tiny": rng.normal(size=(3,))}[case].astype(np.float32)
    counts, edges = histogram(torch.from_numpy(v), 64)
    ref_counts, ref_edges = jnp.histogram(jnp.asarray(v.reshape(-1)), bins=64)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(ref_edges))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))


CFG = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 4, 16, 16)",
           latent_dim=16, filter_spec=[[16, 16], [16, 8]], loss_fn="wgan", gp_weight=10.0,
           adam_beta1=0.0, adam_beta2=0.9, g_clipping=True, d_clipping=True)
PHASE, N = 2, 2


def _tree(state):
    def opt(o):
        return {"count": np.asarray(o.count), "mu": {k: np.asarray(v) for k, v in o.mu.items()},
                "nu": {k: np.asarray(v) for k, v in o.nu.items()}}

    return {"g_params": {k: np.asarray(v) for k, v in state.g_params.items()},
            "d_params": {k: np.asarray(v) for k, v in state.d_params.items()},
            "g_opt": opt(state.g_opt), "d_opt": opt(state.d_opt),
            "ema": {k: np.asarray(v) for k, v in state.ema.items()}}


def test_frozen_histogram_step_matches_reference(monkeypatch):
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", "direct")
    jcfg, cfg = JaxConfig(**CFG).finalize(), Config(**CFG).finalize()
    frozen = frozenset(jax_arch("pgan").init(jax.random.PRNGKey(0), phase=PHASE - 1, cfg=jcfg))
    assert frozen == frozenset(get_architecture("pgan").init(
        torch.Generator().manual_seed(0), phase=PHASE - 1, cfg=cfg, device="meta"))
    jstate, (jgo, jdo) = jax_init_train_state(jax_arch("pgan"), jax.random.PRNGKey(0),
                                              phase=PHASE, cfg=jcfg)
    # a state that has moved once, so the frozen slots are not zero
    tree = _tree(jstate)
    rng = np.random.default_rng(2)
    for part in ("g_opt", "d_opt"):
        tree[part]["count"] = np.int32(1)
        for m in ("mu", "nu"):
            tree[part][m] = {k: np.abs(rng.normal(size=v.shape)).astype(np.float32) * 1e-3
                             for k, v in tree[part][m].items()}
    jstate = jstate._replace(
        g_opt=jstate.g_opt._replace(count=jnp.asarray(1, jnp.int32),
                                    mu={k: jnp.asarray(v) for k, v in tree["g_opt"]["mu"].items()},
                                    nu={k: jnp.asarray(v) for k, v in tree["g_opt"]["nu"].items()}),
        d_opt=jstate.d_opt._replace(count=jnp.asarray(1, jnp.int32),
                                    mu={k: jnp.asarray(v) for k, v in tree["d_opt"]["mu"].items()},
                                    nu={k: jnp.asarray(v) for k, v in tree["d_opt"]["nu"].items()}))
    tstate = train_state_from_numpy(tree, "cpu")

    real = rng.normal(size=jcfg.current_shape(PHASE, N)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jstep = jax.jit(jax_make_train_step(jax_arch("pgan"), jcfg, PHASE, jgo, jdo,
                                        frozen_names=frozen, freeze=True, grad_histograms=True))
    jnew, jm = jstep(jstate, jnp.asarray(real), key, 0.5, 1e-3, 1e-3)

    k_z, _, _, _, k_gamma = jax.random.split(key, 5)
    draws = losses.Draws(
        torch.from_numpy(np.array(jax.random.normal(k_z, (N, cfg.latent_dim)))),
        torch.from_numpy(np.array(jax.random.uniform(k_gamma, (N, 1, 1, 1, 1)))))
    step = make_train_step(get_architecture("pgan"), cfg, PHASE,
                           *make_optimizers_from_config(cfg), frozen_names=frozen, freeze=True,
                           grad_histograms=True, conv_engine="flat")
    new, m = step(tstate, torch.from_numpy(real), None, 0.5, 1e-3, 1e-3, draws=draws)

    ref = _tree(jnew)
    for part, opt in (("g_params", "g_opt"), ("d_params", "d_opt")):
        ours, old = getattr(new, part), getattr(tstate, part)
        for k in ours:
            if k in frozen:  # frozen: the old values, bit for bit
                assert torch.equal(ours[k], old[k]), k
                assert torch.equal(getattr(new, opt).mu[k], getattr(tstate, opt).mu[k]), k
                assert torch.equal(getattr(new, opt).nu[k], getattr(tstate, opt).nu[k]), k
            else:
                np.testing.assert_allclose(ours[k].numpy(), ref[part][k], rtol=1e-3, atol=1e-6,
                                           err_msg=k)
        assert getattr(new, opt).count == int(ref[opt]["count"]) == 2
    # norms and histograms cover exactly the names that train
    for ours, theirs, hists, ref_hists, params in (
            (m.g_norms, jm.g_norms, m.g_hists, jm.g_hists, new.g_params),
            (m.d_norms, jm.d_norms, m.d_hists, jm.d_hists, new.d_params)):
        live = {k for k in params if k not in frozen}
        assert set(ours) == set(theirs) == set(hists) == set(ref_hists) == live
        for k in live:
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-3)
            np.testing.assert_allclose(hists[k][1].numpy(), np.asarray(ref_hists[k][1]),
                                       rtol=1e-3, atol=1e-6 * float(theirs[k]))
            assert float(hists[k][0].sum()) == float(np.asarray(ref_hists[k][0]).sum())
    np.testing.assert_allclose(float(m.max_d_norm), float(jm.max_d_norm), rtol=1e-3)

    # the step's counts are jnp.histogram's of its own (clipped) gradients
    (gg, dg), _ = make_grads_fn(get_architecture("pgan"), cfg, PHASE, conv_engine="flat")(
        tstate.g_params, tstate.d_params, torch.from_numpy(real), draws, 0.5)
    for grads, hists in ((gg, m.g_hists), (dg, m.d_hists)):
        live = [k for k in grads if k not in frozen]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k])) for k in live))
        scale = torch.clamp(1.0 / (gnorm + 1e-16), max=1.0)
        for k in live:
            c, e = jnp.histogram(jnp.asarray((grads[k] * scale).numpy().reshape(-1)), bins=64)
            np.testing.assert_array_equal(hists[k][0].numpy(), np.asarray(c), err_msg=k)
            np.testing.assert_array_equal(hists[k][1].numpy(), np.asarray(e), err_msg=k)


# ---------------------------------------------------------------------------
# Config defaults of the trainer's fields
# ---------------------------------------------------------------------------


def test_trainer_config_fields_keep_the_reference_names_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(Config)}
    # the op formulation's fields, the reference's SARAGAN_* environment variables
    formulation = {"conv_engine", "conv_wgrad", "pool", "stats_dtype", "s2d_max_cin"}
    assert set(ours) - set(ref) == formulation
    for name, default in ours.items():
        if name not in formulation:
            assert default == ref[name], name
    c, r = Config(mixing_nimg=100, stabilizing_nimg=60, compute_dtype="bfloat16",
                  base_batch_size=64, max_global_batch_size=8).finalize(), JaxConfig(
        mixing_nimg=100, stabilizing_nimg=60, compute_dtype="bfloat16", base_batch_size=64,
        max_global_batch_size=8).finalize()
    for name in ("transfer_dtype", "g_lr_rise_niter", "g_lr_decay_niter", "d_lr_rise_niter",
                 "d_lr_decay_niter"):
        assert getattr(c, name) == getattr(r, name), name
    assert [c.batch_size_for_phase(p) for p in range(1, 6)] == [
        r.batch_size_for_phase(p) for p in range(1, 6)]
    # the single-chip big-volume preset: the reference's flags (saragan_tpu/config.py:
    # 448-456), and the flat engine on every device (the reference's preset picks pallas)
    c, r = Config(single_chip_big_volume=True).finalize(), JaxConfig(
        single_chip_big_volume=True).finalize()
    for name in ("remat_offload", "batched_passes", "fused_transitions", "remat"):
        assert getattr(c, name) == getattr(r, name), name
    assert (c.remat_offload, c.batched_passes, c.fused_transitions) == (True, False, False)
    assert c.conv_engine == "unset"
    assert [resolve_conv_engine(c.conv_engine, d, c.single_chip_big_volume)
            for d in ("cpu", "cuda")] == ["flat", "flat"]
    assert resolve_conv_engine("direct", "cuda", True) == "direct"  # an explicit one wins
    with pytest.raises(ValueError, match="conv_engine"):
        Config(conv_engine="pallas").finalize()


# ---------------------------------------------------------------------------
# The trainer's conv engine: left unset, resolved by device, as the reference's
# apply_runtime_opts picks one by backend (saragan_tpu/config.py:500-512)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,device_type,resolved", [
    ("unset", "cpu", "direct"), ("unset", "cuda", "flat"), ("direct", "cuda", "direct"),
    ("direct", "cpu", "direct"), ("flat", "cpu", "flat"), ("flat", "cuda", "flat")])
def test_conv_engine_resolution(engine, device_type, resolved):
    assert resolve_conv_engine(engine, device_type) == resolved


def _cli_config(tmp_path, *extra):
    args = build_parser().parse_args([
        "pgan", str(tmp_path), "--start_shape", "(1, 4, 4, 4)", "--final_shape", "(1, 16, 16, 16)",
        "--starting_phase", "1", "--ending_phase", "2", "--latent_dim", "16",
        "--noise_stddev", "0", "--logdir", str(tmp_path / "run"), *extra])
    return config_from_args(args).finalize()


def test_trainer_resolves_an_unset_engine_on_the_cpu_and_again_on_resume(tmp_path):
    cfg = _cli_config(tmp_path, "--auto_resume")
    assert cfg.conv_engine == "unset"
    for _ in range(2):  # the first run, then an --auto_resume run of the same command
        trainer = Trainer(dataclasses.replace(cfg), device="cpu", prefetch=False)
        trainer.writer.close()
        assert trainer.conv_engine == "direct" and trainer.cfg.conv_engine == "unset"
    with open(tmp_path / "run" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["text"] for e in events if e["tag"] == "config/conv_engine"] == ["direct"] * 2


@pytest.mark.parametrize("engine", ["flat", "direct"])
def test_an_explicit_engine_wins(tmp_path, engine):
    cfg = _cli_config(tmp_path, "--conv_engine", engine)
    assert Trainer(cfg, device="cpu", verbose=False).conv_engine == engine


def test_the_op_formulation_flags_reach_the_trainer_and_its_events(tmp_path):
    """The JAX package's SARAGAN_* choices as CLI flags: the trainer holds them as one
    ``Ops`` value and writes each to events.jsonl."""
    from saragan_tpu_torch.ops.core import Ops

    cfg = _cli_config(tmp_path, "--conv_engine", "gemm_custom", "--conv_wgrad", "einsum",
                      "--pool", "window", "--stats_dtype", "compute", "--s2d_max_cin", "8")
    trainer = Trainer(cfg, device="cpu", prefetch=False)
    trainer.writer.close()
    assert trainer.ops == Ops("gemm_custom", "einsum", "window", "compute", 8)
    assert trainer.conv_engine == "gemm_custom"
    with open(tmp_path / "run" / "events.jsonl") as f:
        events = {e["tag"]: e["text"] for e in map(json.loads, f) if "text" in e}
    assert {k: events[f"config/{k}"] for k in ("conv_engine", "conv_wgrad", "pool",
                                                "stats_dtype", "s2d_max_cin")} == dict(
        conv_engine="gemm_custom", conv_wgrad="einsum", pool="window", stats_dtype="compute",
        s2d_max_cin="8")
    with pytest.raises(ValueError, match="pool"):
        dataclasses.replace(cfg, pool="max").finalize()


def test_a_trainer_leaves_an_unset_engine_unset_for_the_next_trainer(tmp_path, monkeypatch):
    """Two Trainers from one Config (HPO trials, phase-chaining scripts): the first, on
    the CPU, resolves `direct` without writing it into the Config, so the second, on a
    CUDA device, resolves its own engine, `flat`."""
    import saragan_tpu_torch.train.trainer as trainer_mod

    cfg = _cli_config(tmp_path)
    first = Trainer(cfg, device="cpu", verbose=False)
    assert first.conv_engine == "direct" and cfg.conv_engine == "unset"
    # a CUDA device without a card: only the device's type reaches the engine choice
    monkeypatch.setattr(trainer_mod, "resolve_device", lambda device: torch.device("cuda"))
    second = Trainer(cfg, device="cuda", verbose=False)
    assert second.conv_engine == "flat" and cfg.conv_engine == "unset"
    assert first.conv_engine == "direct"


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


@pytest.fixture
def npy_dir(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(13):
        np.save(tmp_path / f"{i:03d}.npy", rng.normal(size=(2, 3, 3)).astype(np.float32))
    return str(tmp_path)


@pytest.mark.parametrize("seed", [0, 42])
def test_dataset_stream_splits_and_clone_equal_reference(npy_dir, seed):
    ours, ref = NumpyPathDataset(npy_dir, seed=seed), JaxDataset(npy_dir, seed=seed)
    assert ours.shape == ref.shape == (1, 2, 3, 3)
    # three epochs and a half of the shuffle stream, in uneven batches
    for size in (5, 3, 8, 13, 7, 4):
        assert ours.batch_paths(size) == ref.batch_paths(size)
    np.testing.assert_array_equal(ours.batch(4), ref.batch(4))
    for a, b in zip(ours.split_by_fraction(0.8), ref.split_by_fraction(0.8)):
        assert list(a) == list(b)
        assert a.batch_paths(6) == b.batch_paths(6)
    a, b = ours.clone(seed_offset=1), ref.clone(seed_offset=1)
    assert a.batch_paths(9) == b.batch_paths(9)


@pytest.mark.parametrize("skip", [0, 3, 13, 40])
def test_fast_forward_equals_reference_and_drawing(npy_dir, skip):
    ours, ref, drawn = (NumpyPathDataset(npy_dir, seed=7), JaxDataset(npy_dir, seed=7),
                        NumpyPathDataset(npy_dir, seed=7))
    ours.batch_paths(2)
    ref.batch_paths(2)
    drawn.batch_paths(2)
    ours.fast_forward(skip)
    ref.fast_forward(skip)
    if skip:
        drawn.batch_paths(skip)
    assert ours.batch_paths(11) == ref.batch_paths(11) == drawn.batch_paths(11)


# ---------------------------------------------------------------------------
# Checkpoint names, pruning, auto-resume
# ---------------------------------------------------------------------------


def _touch(d, names):
    os.makedirs(d, exist_ok=True)
    for n in names:
        open(os.path.join(d, n), "w").close()


LAYOUTS = {
    "empty": [],
    "cadence_only": ["model_1_ckpt_8.npz", "model_1_ckpt_16.npz"],
    "full_states": ["model_1.npz", "model_2_ckpt_8.npz", "model_2_ckpt_8_full.pkl",
                    "model_2_ckpt_16.npz", "model_2_ckpt_16_full.pkl"],
    "interrupted": ["model_1.npz", "model_2_ckpt_12.npz", "model_2_ckpt_12_interrupt.pkl",
                    "model_2_ckpt_8_full.pkl", "events.jsonl"],
    "superseded": ["model_1_ckpt_4_interrupt.pkl", "model_1.npz", "model_2.npz"],
    "phase_done": ["model_1.npz", "model_2_ckpt_4.npz"],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_auto_resume_and_pruning_equal_reference(tmp_path, layout):
    for pkg in ("ours", "ref"):
        _touch(tmp_path / pkg, LAYOUTS[layout])
    for ending in (2, 3):
        a = ckpt.find_auto_resume(str(tmp_path / "ours"), ending)
        b = jax_ckpt.find_auto_resume(str(tmp_path / "ref"), ending)
        assert (a is None) == (b is None)
        if a is not None:
            assert (os.path.basename(a.continue_path or ""), a.starting_phase, a.complete) == (
                os.path.basename(b.continue_path or ""), b.starting_phase, b.complete)
    for phase in (1, 2):
        protect = {str(tmp_path / "ours" / "model_2_ckpt_8.npz")}
        da = ckpt.prune_cadence_checkpoints(str(tmp_path / "ours"), phase, 1, protect=protect)
        db = jax_ckpt.prune_cadence_checkpoints(
            str(tmp_path / "ref"), phase, 1, protect={str(tmp_path / "ref" / "model_2_ckpt_8.npz")})
        assert sorted(map(os.path.basename, da)) == sorted(map(os.path.basename, db))
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref"))
    for step in (None, 0, 24):
        assert ckpt.phase_checkpoint_path("d", 3, step) == jax_ckpt.phase_checkpoint_path(
            "d", 3, step)


def test_full_state_round_trip(tmp_path):
    cfg = Config(**CFG).finalize()
    from saragan_tpu_torch.train.step import init_train_state

    state, _ = init_train_state(get_architecture("pgan"), torch.Generator().manual_seed(0),
                                phase=1, cfg=cfg, device="cpu")
    state = state._replace(g_opt=state.g_opt._replace(count=5))
    counters = {"global_step": 12, "alpha": 0.25, "mixing": True, "phase": 1}
    path = ckpt.save_full_state(str(tmp_path / "model_1_ckpt_12_full"), state, counters)
    assert path.endswith("_full.pkl")
    back, c = ckpt.load_full_state(path, "cpu")
    assert c == counters and back.g_opt.count == 5
    for part in ("g_params", "d_params", "ema"):
        for k, v in getattr(state, part).items():
            assert torch.equal(getattr(back, part)[k], v)
    for k, v in state.d_opt.nu.items():
        assert torch.equal(back.d_opt.nu[k], v)
