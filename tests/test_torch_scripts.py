"""The quality-evidence drivers of the port (``saragan_tpu_torch.scripts``) against the
JAX package's ``scripts/``, on the CPU at phase <= 2 sizes:

* the synthetic data (cubic pyramid, anisotropic field, 2-D JPEGs) bit-equal to the JAX
  drivers' generators for the same seeds, the normalisation statistics equal;
* the gates on the JAX package's recorded trajectories (``docs/evidence``): the flagship
  1 -> 6 run passes with 5/6 phases improved and an aggregate of -1.755, phase 5 only
  through the fade-recovery clause; the phase-7 leg passes the recovery gate, the phase-8
  leg the finiteness gate;
* synthetic trajectories that fail each clause in turn, and the 2-D caps phase by phase;
* a driver without ``--device`` refuses to run on a host without a GPU;
* the small API counterparts: ``alpha_update``, ``ExtendedEMA``, ``ones_initializer``,
  ``load_spec``.

The drivers' ``--smoke --device cpu`` runs are in ``test_torch_scripts_smoke.py`` (the
convergence drivers), ``test_torch_scripts_zoo.py`` (families, HPO),
``test_torch_scripts_band.py`` and ``test_torch_scripts_receipt.py``, so that they run
beside each other.
"""

import filecmp
import importlib.util
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saragan_tpu import config as jax_config
from saragan_tpu import core as jax_core
from saragan_tpu import ops as jax_ops
from saragan_tpu.optim.ema import ExtendedEMA as JaxExtendedEMA
from saragan_tpu_torch import config, core, ops
from saragan_tpu_torch.optim.ema import ExtendedEMA
from saragan_tpu_torch.scripts import _evidence as ev

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EVIDENCE = ROOT / "docs" / "evidence"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {n: _jax_script(n) for n in ("convergence_run", "convergence_run_flagship",
                                        "convergence_run_2d")}


def _trajectory(name):
    return json.loads((EVIDENCE / name).read_text())["trajectory"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,size", [(0, 8), (3, 16), (10_000, 32)])
def test_cubic_volume_bit_equal(jax_scripts, seed, size):
    ref = jax_scripts["convergence_run"].make_blob_volume(np.random.default_rng(seed), size)
    ours = ev.make_blob_volume(np.random.default_rng(seed), size)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    for s in (4, size // 2):
        assert np.array_equal(ev.downsample(ours, s),
                              jax_scripts["convergence_run"].downsample(ref, s))


def test_cubic_pyramid_and_stats_bit_equal(jax_scripts, tmp_path):
    ref = jax_scripts["convergence_run"].build_dataset(str(tmp_path / "jax"), n=5, master=16)
    ours = ev.build_dataset(str(tmp_path / "port"), n=5, master=16)
    assert ours == ref
    for level in ("4x4", "8x8", "16x16"):
        names = sorted(p.name for p in (tmp_path / "jax" / level).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "port" / level).iterdir())
        for n in names:
            assert filecmp.cmp(tmp_path / "jax" / level / n, tmp_path / "port" / level / n,
                               shallow=False)


@pytest.mark.parametrize("hw", [4, 8, 16, 64])
def test_aniso_field_bit_equal(jax_scripts, hw):
    for seed in (31_000_000, 31_000_007, 31_500_003):
        ref = jax_scripts["convergence_run_flagship"].make_blob_volume_aniso(seed, hw)
        ours = ev.make_blob_volume_aniso(seed, hw)
        assert ours.shape == (max(1, hw // 4), hw, hw) and np.array_equal(ours, ref)


def test_aniso_level_and_stats_bit_equal(jax_scripts, tmp_path):
    jax_scripts["convergence_run_flagship"].build_level(str(tmp_path / "jax"), 8, n=4)
    ev.build_level(str(tmp_path / "port"), 8, n=4)
    for i in range(4):
        assert filecmp.cmp(tmp_path / "jax" / "8x8" / f"v{i:04d}.npy",
                           tmp_path / "port" / "8x8" / f"v{i:04d}.npy", shallow=False)
    sample = np.stack([jax_scripts["convergence_run_flagship"].make_blob_volume_aniso(
        31_500_000 + i, 64) for i in range(64)])
    assert ev.aniso_stats() == (float(sample.mean()), float(sample.std()))


def test_2d_images_and_jpegs_bit_equal(jax_scripts, tmp_path):
    mod = jax_scripts["convergence_run_2d"]
    for seed in (0, 5, 2**30):
        assert np.array_equal(ev.make_blob_image(np.random.default_rng(seed)),
                              mod.make_blob_image(np.random.default_rng(seed)))
    mod.build_dataset(str(tmp_path / "jax"), n=20)
    ev.build_dataset_2d(str(tmp_path / "port"), n=20)
    for split in ("train", "test"):
        names = sorted(p.name for p in (tmp_path / "jax" / split / "n001").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "port" / split / "n001").iterdir())
        for n in names:
            assert filecmp.cmp(tmp_path / "jax" / split / "n001" / n,
                               tmp_path / "port" / split / "n001" / n, shallow=False)


# ---------------------------------------------------------------------------
# gates on the JAX package's recorded evidence
# ---------------------------------------------------------------------------


def test_flagship_gate_on_recorded_trajectory():
    t = _trajectory("trajectory_p1-6.json")
    v = ev.band_gate(t)
    assert v.ok and not v.failures
    assert (v.improved, v.n_phases) == (5, 6)
    assert round(v.total_rel, 3) == -1.755
    assert v.clauses == {1: "improved", 2: "improved", 3: "improved", 4: "improved",
                         5: "recovered", 6: "improved"}
    # phase 5: +9.2 % (54.06 -> 59.03), beyond the noise tolerance, within the cap, and
    # below every later in-phase reading (the mid-fade 124.79 the smallest)
    rel5 = (v.last[5] - v.first[5]) / v.first[5]
    assert ev.NOISE_TOL < rel5 < ev.REGRESSION_CAP and round(rel5, 3) == 0.092
    assert round(v.first[5], 2) == 54.06 and round(v.last[5], 2) == 59.03
    in_phase = [e["FID"] for e in t if e["phase"] == 5 and e["suffix"] == ""][1:]
    assert round(min(in_phase), 2) == 124.79 and v.last[5] < min(in_phase)
    # the cubic driver's extra clause holds too (phase 6 improved)
    assert ev.band_gate(t, require_final_improved=True).ok


def test_big_phase_gates_on_recorded_legs():
    v7 = ev.recovery_gate(_trajectory("trajectory_p7-7.json"), 7)
    assert v7.ok and v7.clauses == {7: "recovered"}
    assert round(v7.last[7], 2) == 21.29
    v8 = ev.finite_gate(_trajectory("trajectory_p8-8.json"), 8)
    assert v8.ok and math.isfinite(v8.last[8])
    # the phase-7 leg does not pass the schedule's band gate: its first reading is the
    # upscaled phase-6 generator (13.50 -> 21.29)
    assert not ev.band_gate(_trajectory("trajectory_p7-7.json")).ok


# ---------------------------------------------------------------------------
# synthetic failures
# ---------------------------------------------------------------------------


def _traj(phases):
    """phases: {phase: ([readings under the training weights], final EMA reading)}."""
    out = []
    for ph, (readings, final) in phases.items():
        for i, r in enumerate(readings):
            out.append({"phase": ph, "step": 64 * (i + 1), "suffix": "", "FID": r})
            out.append({"phase": ph, "step": 64 * (i + 1), "suffix": "_EMA", "FID": r})
        out.append({"phase": ph, "step": 64 * len(readings), "suffix": "_test", "FID": final})
        out.append({"phase": ph, "step": 64 * len(readings), "suffix": "_validation",
                    "FID": final})
    return out


SYNTHETIC = {
    # phase 2 regresses +150 %: over the cap, whatever its recovery
    "cap": ({1: ([10.0, 5.0], 1.0), 2: ([10.0, 40.0], 25.0), 3: ([10.0, 8.0], 1.0)},
            {2: "cap"}, ["exceeds the cap"]),
    # phase 2 regresses +50 % and ends above its smallest later reading
    "recovery": ({1: ([10.0, 5.0], 4.0), 2: ([10.0, 12.0, 14.0], 15.0),
                  3: ([10.0, 8.0], 5.0)}, {2: "no recovery"}, ["no fade recovery"]),
    # two phases within the noise, one improving hard: no majority
    "majority": ({1: ([10.0, 9.0], 10.3), 2: ([10.0, 9.0], 10.2), 3: ([10.0, 5.0], 2.0)},
                 {1: "noise", 2: "noise", 3: "improved"}, ["phases improved"]),
    # one phase a hair better, one within the noise: the run as a whole got worse
    "aggregate": ({1: ([10.0, 9.0], 9.9), 2: ([10.0, 9.0], 10.4)},
                  {1: "improved", 2: "noise"}, ["aggregate"]),
}


@pytest.mark.parametrize("clause", sorted(SYNTHETIC))
def test_band_gate_fails_each_clause(clause):
    phases, clauses, messages = SYNTHETIC[clause]
    v = ev.band_gate(_traj(phases))
    assert not v.ok
    assert len(v.failures) == len(messages)
    for f, m in zip(v.failures, messages):
        assert m in f
    for ph, c in clauses.items():
        assert v.clauses[ph] == c


def test_band_gate_passes_recovery_and_noise():
    v = ev.band_gate(_traj({1: ([10.0, 5.0], 4.0), 2: ([10.0, 30.0, 18.0], 15.0),
                            3: ([10.0, 9.0], 10.4), 4: ([10.0, 8.0], 6.0)}))
    assert v.ok and v.clauses == {1: "improved", 2: "recovered", 3: "noise", 4: "improved"}


def test_band_gate_final_phase_clause():
    t = _traj({1: ([10.0, 5.0], 4.0), 2: ([10.0, 5.0], 4.0), 3: ([10.0, 9.0], 10.3)})
    assert ev.band_gate(t).ok
    v = ev.band_gate(t, require_final_improved=True)
    assert not v.ok and v.failures == ["final phase 3 did not improve over its first reading"]


@pytest.mark.parametrize("phase,rel,ok", [(1, 0.049, True), (1, 0.06, False),
                                          (2, 0.079, True), (2, 0.09, False),
                                          (3, 0.039, True), (3, 0.05, False),
                                          (4, 0.039, True), (4, 0.05, False),
                                          (5, 0.079, True), (5, 0.09, False)])
def test_2d_caps_per_phase(phase, rel, ok):
    phases = {p: ([10.0, 5.0], 2.0) for p in range(1, 6)}
    phases[phase] = ([10.0, 9.0], 10.0 * (1 + rel))
    v = ev.caps_gate_2d(_traj(phases))
    assert v.ok == ok
    assert v.clauses[phase] == ("within cap" if ok else "cap")
    cap = ev.NOISE_TOL_PER_PHASE_2D.get(phase, ev.DEFAULT_TOL_2D)
    assert cap == {1: 0.05, 2: 0.08, 3: 0.04, 4: 0.04}.get(phase, 0.08)


def test_recovery_and_finite_gates_fail():
    t = [{"phase": 7, "step": 1, "suffix": "", "FID": 13.5},
         {"phase": 7, "step": 2049, "suffix": "", "FID": 69.4},
         {"phase": 7, "step": 4097, "suffix": "", "FID": 32.2},
         {"phase": 7, "step": 6144, "suffix": "_validation", "FID": 40.0}]
    v = ev.recovery_gate(t, 7)
    assert not v.ok and "no recovery" in v.failures[0]
    t[-1]["FID"] = 30.0
    assert ev.recovery_gate(t, 7).ok
    t[-1]["FID"] = float("nan")
    assert not ev.recovery_gate(t, 7).ok and not ev.finite_gate(t, 7).ok
    assert not ev.finite_gate(t[:-1], 7).ok


def test_phase_table_rate_counts_a_stall():
    """A phase's steps per second is its steps over their time outside the passes: one
    interval stalled to a tenth of the rate moves it, while the median of the intervals
    does not.  A recorder without ``ru_maxrss`` (NaN) reports no peak, and the largest RSS
    read at a pass beside it."""
    rates = [10.0, 10.0, 1.0, 10.0]  # steps/s of the intervals; batch 4, 400 images each
    passes = [dict(phase=1, step=0, steps_per_s=None, rss_mib=100.0,
                   rss_peak_mib=float("nan"), cuda_peak_mib=None, metric_s=1.0)]
    traj = [dict(phase=1, step=0, suffix="", time=0.0, FID=10.0)]
    for i, r in enumerate(rates, 1):
        passes.append(dict(passes[0], step=400 * i, steps_per_s=r, rss_mib=100.0 + i))
        traj.append(dict(traj[0], step=400 * i, time=float(i)))
    traj[-1]["suffix"], traj[-1]["FID"] = "_EMA", 5.0
    row = ev.phase_table(traj, passes)[1]
    # 4 x 100 steps in 10 + 10 + 100 + 10 s
    assert row["steps_per_s"] == pytest.approx(400 / 130)
    assert row["steps_per_s_median"] == 10.0
    assert row["rss_peak_mib"] is None and row["rss_max_at_passes_mib"] == 104.0
    assert (row["first"], row["last"], row["rel"]) == (10.0, 5.0, -0.5)


# ---------------------------------------------------------------------------
# the drivers' device
# ---------------------------------------------------------------------------


def test_drivers_refuse_to_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from saragan_tpu_torch.scripts import convergence_run_flagship as m

    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.main([str(tmp_path), "2", "--smoke"])


# ---------------------------------------------------------------------------
# the small API counterparts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha,mixing,start,batch,world", [
    (1.0, 0, 1.0, 4, 2), (1.0, 80, 1.0, 4, 2), (0.05, 80, 1.0, 4, 2), (1.0, 3, 1.0, 4, 2),
    (0.7, 1000, 0.8, 16, 1)])
def test_alpha_update_matches_jax(alpha, mixing, start, batch, world):
    ref = jax_ops.alpha_update(jnp.asarray(alpha, jnp.float32), mixing, start, batch, world)
    ours = ops.alpha_update(torch.tensor(alpha), mixing, start, batch, world)
    assert ours.dtype == torch.float32
    assert float(ours) == float(ref)


def test_alpha_update_reference_cases():
    assert float(ops.alpha_update(torch.tensor(1.0), 0, 1.0, 4, 2)) == 0.0
    np.testing.assert_allclose(float(ops.alpha_update(torch.tensor(1.0), 80, 1.0, 4, 2)), 0.9,
                               rtol=1e-6)
    assert float(ops.alpha_update(torch.tensor(0.05), 80, 1.0, 4, 2)) == 0.0


def test_extended_ema_matches_jax():
    rng = np.random.default_rng(0)
    p0 = {"g/w": rng.normal(size=(3, 4)).astype(np.float32),
          "d/b": rng.normal(size=(5,)).astype(np.float32)}
    steps = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    jema = JaxExtendedEMA({k: jnp.asarray(v) for k, v in p0.items()}, 0.9)
    ema = ExtendedEMA({k: torch.tensor(v) for k, v in p0.items()}, 0.9)
    for s in steps:
        jp = {k: jnp.asarray(v) for k, v in s.items()}
        tp = {k: torch.tensor(v) for k, v in s.items()}
        assert jema.apply(jp) is jp and ema.apply(tp) is tp
    for k in p0:
        np.testing.assert_allclose(ema.average(k).numpy(), np.asarray(jema.average(k)),
                                   rtol=1e-6, atol=1e-7)
    live = {k: torch.tensor(v) for k, v in steps[-1].items()}
    swapped = ema.assign_ema_weights(live)
    jswapped = jema.assign_ema_weights({k: jnp.asarray(v) for k, v in steps[-1].items()})
    for k in p0:
        np.testing.assert_allclose(swapped[k].numpy(), np.asarray(jswapped[k]), rtol=1e-6,
                                   atol=1e-7)
        assert swapped[k].data_ptr() != ema.shadow[k].data_ptr()
    assert ema.restore_original_weights() is live
    jema.restore_original_weights()
    with pytest.raises(RuntimeError, match="assign_ema_weights"):
        ema.restore_original_weights()


def test_ones_initializer_and_load_spec(tmp_path):
    ours = core.ones_initializer()(torch.Generator(), (2, 3), torch.float32)
    ref = jax_core.ones_initializer()(None, (2, 3), jnp.float32)
    assert ours.dtype == torch.float32 and np.array_equal(ours.numpy(), np.asarray(ref))
    spec = {"kernel_spec": [[[], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
            "filter_spec": [[32, 32], [16, 16]]}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    for key in spec:
        assert config.load_spec(str(path), key) == jax_config.load_spec(str(path), key)
        assert config.load_spec(str(path), key) == spec[key]
