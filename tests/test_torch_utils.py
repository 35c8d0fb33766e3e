"""``saragan_tpu_torch/utils.py`` against the JAX package's ``saragan_tpu/utils.py`` on the
same inputs: the same results, the same printed lines, the same random boxes."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saragan_tpu import utils as jutils
from saragan_tpu_torch import utils

torch.set_num_threads(1)


def test_count_parameters_and_metric_samples():
    shapes = {"generator/a/weight": (3, 4), "generator/b/bias": (5,),
              "discriminator/c/weight": (2, 2, 7)}
    ours = {k: torch.zeros(s) for k, s in shapes.items()}
    ref = {k: jnp.zeros(s) for k, s in shapes.items()}
    for scope in ("", "generator", "discriminator", "generator/a", "nothing"):
        assert utils.count_parameters(ours, scope) == jutils.count_parameters(ref, scope)
    for args in ((None, 4, 2), (None, 1, 2), (0, 1, 3), (99, 4, 2), (None, 8, 1)):
        assert utils.get_num_metric_samples(*args) == jutils.get_num_metric_samples(*args)
    assert utils.parse_tuple("(1, 4, 4, 4)") == jutils.parse_tuple("(1, 4, 4, 4)")


@pytest.mark.parametrize("name", ["g/w", "g/b", "nope"])
def test_dump_weight_prints_the_reference_line(capsys, name):
    values = {"g/w": np.arange(6, dtype=np.float32).reshape(2, 3) + 0.5,
              "g/b": np.float32(2.25)}
    utils.dump_weight_for_debugging({k: torch.as_tensor(v) for k, v in values.items()}, name)
    ours = capsys.readouterr().out
    jutils.dump_weight_for_debugging({k: jnp.asarray(v) for k, v in values.items()}, name)
    assert ours == capsys.readouterr().out


def test_print_study_summary_prints_the_reference_lines(capsys):
    trial = types.SimpleNamespace(value=0.25, params={"generator_LR": 1e-3, "optimizer": "Adam"})
    study = types.SimpleNamespace(trials=[trial, trial, trial], best_trial=trial)
    utils.print_study_summary(study)
    ours = capsys.readouterr().out
    jutils.print_study_summary(study)
    assert ours == capsys.readouterr().out


@pytest.mark.parametrize("min_width,max_width", [(2, 4), ((1, 2, 3), (2, 5, 6)), (3, 3)])
def test_uniform_box_sampler_draws_the_reference_box(min_width, max_width):
    arr = np.random.default_rng(0).normal(size=(8, 10, 12))
    for seed in range(5):
        s, box = utils.uniform_box_sampler(arr, min_width, max_width,
                                           np.random.default_rng(seed))
        rs, rbox = jutils.uniform_box_sampler(arr, min_width, max_width,
                                              np.random.default_rng(seed))
        assert s == rs
        np.testing.assert_array_equal(box, rbox)


def test_get_verbosity_outside_a_process_group(monkeypatch):
    monkeypatch.delenv("SARAGAN_WORKER_ID", raising=False)
    for flags in ((False, False), (True, False), (False, True)):
        assert utils.get_verbosity(*flags) == jutils.get_verbosity(*flags)
    monkeypatch.setenv("SARAGAN_WORKER_ID", "1")
    for flags in ((False, False), (True, False), (False, True)):
        assert utils.get_verbosity(*flags) == jutils.get_verbosity(*flags)
