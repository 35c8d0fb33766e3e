"""The check that decides ``correct`` catches the faults a cell can have: the harness is
driven past its look for a chip, on the CPU at a tiny size, with the timed path broken
underneath (a train step that returns its state unchanged; a step that leaves out half
of the batch and takes the mean over the rest; only the mixing step returning its state
unchanged, or blending with 1 - alpha), and ``correct`` comes out false.  A sound run of
the same cells comes out true.  The lower-precision control (the reference in fp8 in the
program's place) and the same faults planted in the reference fail the limits too, as
``portbench.calibrate`` reads them on the card at the cells' own sizes."""

from __future__ import annotations

import pytest

from portbench import calibrate, spec
from portbench.run import run_cell

from conftest import TINY_LIMITS

SEED = 2 ** 31 + 3
CELLS = ["tiny-pgan-train", "tiny-surfgan-train"]


def _cell(root, name):
    return spec.Cell(spec.load_benchmark(root), name, root)


def _run(root, name):
    return run_cell(_cell(root, name), SEED, 0.5, False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(tiny_root, name):
    res = _run(tiny_root, name)
    assert res["correct"], res["checks"]


def _broken_step(monkeypatch, wrap, mixing_only=False):
    import saragan_tpu_torch.train.step as step_mod

    make = step_mod.make_train_step

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)
        return wrap(step) if kwargs.get("freeze") or not mixing_only else step

    monkeypatch.setattr(step_mod, "make_train_step", make_broken)


def _unchanged(step):
    def unchanged(state, real, rng, alpha, g_lr, d_lr, draws=None):
        _, metrics = step(state, real, rng, alpha, g_lr, d_lr, draws=draws)
        return state, metrics
    return unchanged


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged_fails(tiny_root, monkeypatch, name):
    _broken_step(monkeypatch, _unchanged)
    res = _run(tiny_root, name)
    assert not res["correct"] and res["checks"]["change_gap"]["value"] > 0.9


@pytest.mark.parametrize("name", CELLS)
def test_a_mixing_step_that_returns_its_state_unchanged_fails(tiny_root, monkeypatch, name):
    _broken_step(monkeypatch, _unchanged, mixing_only=True)
    res = _run(tiny_root, name)
    assert not res["correct"] and res["checks"]["mix_change_gap"]["value"] > 0.9


@pytest.mark.parametrize("name", CELLS)
def test_a_mixing_step_with_a_wrong_alpha_fails(tiny_root, monkeypatch, name):
    def wrap(step):
        def swapped(state, real, rng, alpha, g_lr, d_lr, draws=None):
            return step(state, real, rng, 1.0 - alpha, g_lr, d_lr, draws=draws)
        return swapped

    _broken_step(monkeypatch, wrap, mixing_only=True)
    res = _run(tiny_root, name)
    assert not res["correct"], res["checks"]
    assert res["checks"]["grad_diff"]["value"] <= TINY_LIMITS[name]["grad_diff"]


@pytest.mark.parametrize("name", ["tiny-pgan-train", "tiny-surfgan-train"])
def test_a_step_that_leaves_out_half_the_batch_fails(tiny_root, monkeypatch, name):
    from saragan_tpu_torch.ops.core import NoiseByName

    def wrap(step):
        def half(state, real, rng, alpha, g_lr, d_lr, draws=None):
            n = real.shape[0] // 2
            cut = {f: getattr(draws, f)[:n] for f in ("z", "gamma", "z_mix")
                   if getattr(draws, f) is not None}
            if isinstance(draws.noise, NoiseByName):
                cut["noise"] = NoiseByName({k: v[:n] for k, v in draws.noise.tensors.items()})
            return step(state, real[:n], rng, alpha, g_lr, d_lr, draws=draws._replace(**cut))
        return half

    _broken_step(monkeypatch, wrap)
    res = _run(tiny_root, name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_controls_fail_the_training_limits(tiny_root, name):
    """The reference in fp8 (e4m3 values, e5m2 gradients), with half of the batch left out,
    and with 1 - alpha in its mixing steps, each in the program's place, judged by the
    cell's limits; the reference rounded to the cell's own float32 is correct."""
    got = calibrate.train_controls(_cell(tiny_root, name), SEED, device="cpu")
    assert set(got) == set(calibrate.CONTROLS)
    for control in ("float8_control", "half_batch", "mix_alpha"):
        assert got[control]["correct"] is False, (control, got[control]["numbers"])
    assert got["rounded_witness"]["correct"] is True, got["rounded_witness"]["numbers"]
