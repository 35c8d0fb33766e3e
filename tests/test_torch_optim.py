"""The port's eight optimizers against the JAX package's (optax 0.2.6): three updates of a
flat dict holding a weight, a bias, a noise strength, a spectral ``*_u`` vector and one
all-zero weight, through ``saragan_tpu.optim.factory.make_optimizer`` and the port's
``make_optimizer``; the parameters and every slot within rtol 1e-6 / atol 1e-7 in f32.
Also: RAdam's rectified branch, LARS without momentum, beta2 = 1, freeze selection per
optimizer against the reference's ``freeze_select``, the full-state and numpy round
trips bit for bit, a trajectory continued in both packages from one converted state,
and the Config fields the optimizers read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.optim.factory import make_optimizer as jax_make_optimizer
from saragan_tpu.optim.freeze import freeze_select as jax_freeze_select
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import (opt_state_from_numpy, opt_state_from_optax,
                                       opt_state_into_optax, opt_state_to_numpy,
                                       params_from_numpy, train_state_from_numpy,
                                       train_state_to_numpy)
from saragan_tpu_torch.optim import factory
from saragan_tpu_torch.optim.factory import OPTIMIZERS, AdamState, OptState, make_optimizer
from saragan_tpu_torch.optim.freeze import freeze_select
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train.step import TrainState

torch.set_num_threads(1)

HYPER = dict(beta1=0.1, beta2=0.9, rho=0.9, momentum=0.8, weight_decay=0.05)
RTOL, ATOL = 1e-6, 1e-7


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"g/conv/weight": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
            "g/conv/bias": np.zeros(4, np.float32),
            "g/conv/noise_strength": np.zeros((), np.float32),
            "d/dense/weight": rng.normal(size=(6, 3)).astype(np.float32),
            "d/dense/weight_u": rng.normal(size=(1, 3)).astype(np.float32),
            "d/zero/weight": np.zeros((2, 5), np.float32)}


def _grads(params, rng, scale=1.0):
    g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32) for k, v in params.items()}
    g["d/dense/weight_u"][...] = 0  # non-trainable: never a gradient
    g["d/zero/weight"][...] = 0
    return g


def _run_both(name, steps, hyper=HYPER, lrs=(1e-2, 5e-3, 2e-2)):
    params = _params()
    jopt, opt = jax_make_optimizer(name, **hyper), make_optimizer(name, **hyper)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    p = params_from_numpy(params, "cpu")
    s = opt.init(p)
    rng = np.random.default_rng(1)
    for i in range(steps):
        g = _grads(params, rng, scale=10.0 ** -(i % 3))
        lr = lrs[i % len(lrs)]
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr)
        p, s = opt.update(params_from_numpy(g, "cpu"), s, p, lr)
    return opt, (jp, js), (p, s)


def _assert_match(opt, ref, ours, steps):
    (jp, js), (p, s) = ref, ours
    for k, v in jp.items():
        np.testing.assert_allclose(p[k].numpy(), np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=k)
    ref_slots = opt_state_from_optax(opt, js)
    assert set(s.slots) == set(opt.slot_names) == set(ref_slots) - {"count"}
    for slot in opt.slot_names:
        for k, v in ref_slots[slot].items():
            np.testing.assert_allclose(s.slots[slot][k].numpy(), v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{slot} {k}")
    assert s.count == steps
    if "count" in opt.optax_paths:
        assert int(ref_slots["count"]) == steps


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name):
    opt, ref, ours = _run_both(name, 3)
    _assert_match(opt, ref, ours, 3)
    p = ours[0]
    # every parameter that has a gradient or is decayed moved; the spectral vector and
    # the all-zero weight without a gradient did not (trust ratio 1, no decay of *_u)
    assert not torch.equal(p["g/conv/weight"], torch.from_numpy(_params()["g/conv/weight"]))
    assert torch.equal(p["d/dense/weight_u"], torch.from_numpy(_params()["d/dense/weight_u"]))
    assert torch.equal(p["d/zero/weight"], torch.zeros(2, 5))


def test_radam_rectified_branch_matches_optax():
    """beta2 0.8: rho_t stays below 5 for six steps, then the rectified update."""
    hyper = dict(HYPER, beta2=0.8)
    branches = [factory._radam_rect(0.8, t)[0] for t in range(1, 9)]
    assert branches == [False] * 6 + [True] * 2
    opt, ref, ours = _run_both("RAdam", 8, hyper)
    _assert_match(opt, ref, ours, 8)


def test_lars_without_momentum_matches_optax():
    hyper = dict(HYPER, momentum=0.0)
    opt, ref, ours = _run_both("LARS", 3, hyper)
    assert opt.slot_names == ()
    _assert_match(opt, ref, ours, 3)


def test_beta2_one_gives_the_references_nonfinite_values():
    """A trial can draw beta2 near 1 (the search space is [0.75, 1]); at exactly 1 Adam's
    bias correction is 0 and both packages give the same inf/nan pattern, and RAdam's
    constructor raises in both."""
    hyper = dict(HYPER, beta2=1.0)
    _, (jp, _), (p, _) = _run_both("Adam", 2, hyper)
    for k, v in jp.items():
        np.testing.assert_array_equal(np.isnan(p[k].numpy()), np.isnan(np.asarray(v)), k)
        np.testing.assert_array_equal(np.isinf(p[k].numpy()), np.isinf(np.asarray(v)), k)
    assert any(np.isnan(np.asarray(v)).any() for v in jp.values())
    with pytest.raises(ZeroDivisionError):
        jax_make_optimizer("RAdam", **hyper)
    with pytest.raises(ZeroDivisionError):
        make_optimizer("RAdam", **hyper)


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError, match="not recognized"):
        make_optimizer("Lion")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_freeze_select_per_optimizer_matches_reference(name):
    """The frozen names keep their old value in every slot; the count takes the new
    one; the same selection as the reference's freeze_select on optax's state."""
    opt, (jp_old, js_old), (p_old, s_old) = _run_both(name, 2)
    rng = np.random.default_rng(7)
    g = _grads(_params(), rng)
    jp_new, js_new = jax_make_optimizer(name, **HYPER).update(
        {k: jnp.asarray(v) for k, v in g.items()}, js_old, jp_old, 1e-2)
    p_new, s_new = opt.update(params_from_numpy(g, "cpu"), s_old, p_old, 1e-2)
    frozen = frozenset({"g/conv/weight", "d/dense/weight"})
    sel = freeze_select(s_old, s_new, frozen)
    ref = opt_state_from_optax(opt, jax_freeze_select(js_old, js_new, frozen))
    assert sel.count == s_new.count == 3
    for slot in opt.slot_names:
        for k in p_old:
            want = s_old.slots[slot][k] if k in frozen else s_new.slots[slot][k]
            assert torch.equal(sel.slots[slot][k], want), (slot, k)
            np.testing.assert_allclose(sel.slots[slot][k].numpy(), ref[slot][k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{slot} {k}")
    p_sel = freeze_select(p_old, p_new, frozen)
    for k in p_old:
        assert torch.equal(p_sel[k], p_old[k] if k in frozen else p_new[k]), k


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_state_round_trips_bit_equal(name, tmp_path):
    """save_full_state / load_full_state and train_state_{to,from}_numpy give back every
    parameter, slot and count bit for bit."""
    opt, _, (p, s) = _run_both(name, 2)
    g, d = ({k: v for k, v in p.items() if k.startswith(pre)} for pre in ("g/", "d/"))

    def slots_of(prefix):
        return OptState(s.count, {n: {k: v for k, v in sl.items() if k.startswith(prefix)}
                                  for n, sl in s.slots.items()})

    state = TrainState(g, d, slots_of("g/"), slots_of("d/"),
                       {k: v.clone() + 1 for k, v in p.items()})
    path = ckpt.save_full_state(str(tmp_path / "full"), state, {"global_step": 5})
    back, counters = ckpt.load_full_state(path, "cpu")
    numpy_back = train_state_from_numpy(train_state_to_numpy(state), "cpu")
    assert counters == {"global_step": 5}
    for b in (back, numpy_back):
        for part in ("g_params", "d_params", "ema"):
            assert getattr(b, part).keys() == getattr(state, part).keys()
            for k, v in getattr(state, part).items():
                assert torch.equal(getattr(b, part)[k], v), (part, k)
        for part in ("g_opt", "d_opt"):
            a, o = getattr(b, part), getattr(state, part)
            assert a.count == o.count == 2 and a.slots.keys() == o.slots.keys()
            for slot, entries in o.slots.items():
                for k, v in entries.items():
                    assert torch.equal(a.slots[slot][k], v), (part, slot, k)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_trajectory_continues_from_a_converted_state(name):
    """Two updates in the port, the state carried into optax's tree
    (``opt_state_into_optax``), then two more updates in each package: they agree."""
    opt, _, (p, s) = _run_both(name, 2)
    jopt = jax_make_optimizer(name, **HYPER)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    js = opt_state_into_optax(opt, opt_state_to_numpy(s), jopt.init(jp))
    if "count" in opt.optax_paths:
        assert int(opt_state_from_optax(opt, js)["count"]) == 2
    rng = np.random.default_rng(3)
    for lr in (1e-2, 3e-3):
        g = _grads(_params(), rng)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr)
        p, s = opt.update(params_from_numpy(g, "cpu"), s, p, lr)
    _assert_match(opt, (jp, js), (p, s), 4)


def test_opt_state_numpy_form_and_adam_state():
    s = AdamState(4, {"a": torch.ones(2)}, {"a": torch.zeros(2)})
    assert s.mu["a"].sum() == 2 and s.count == 4 and s._replace(count=5).count == 5
    tree = opt_state_to_numpy(s)
    assert set(tree) == {"count", "mu", "nu"} and tree["count"].dtype == np.int32
    back = opt_state_from_numpy(tree, "cpu")
    assert back.count == 4 and torch.equal(back.nu["a"], s.nu["a"])
    with pytest.raises(AttributeError):
        s.trace


@pytest.mark.parametrize("kw", [
    {}, dict(d_use_different_rho=True, d_rho=0.5, rho=0.7),
    dict(d_use_different_momentum=True, d_momentum=0.1, momentum=0.3),
    dict(d_use_different_weight_decay=True, d_weight_decay=0.2, weight_decay=0.4),
    dict(rho=0.6, momentum=0.2, weight_decay=0.3)],
    ids=["defaults", "rho", "momentum", "weight_decay", "mirrored"])
def test_config_optimizer_fields_finalize_as_the_reference(kw):
    """D's rho, momentum and weight decay mirror G's unless d_use_different_*, and the
    optimizers get the finalized values."""
    names = ("rho", "d_rho", "momentum", "d_momentum", "weight_decay", "d_weight_decay",
             "g_annealing", "d_annealing")
    ref = JaxConfig(optimizer="LARS", d_optimizer="LARS", **kw).finalize()
    ours = Config(optimizer="LARS", d_optimizer="LARS", **kw).finalize()
    assert {n: getattr(ours, n) for n in names} == {n: getattr(ref, n) for n in names}
    g, d = factory.make_optimizers_from_config(ours)
    assert (g.rho, g.momentum, g.weight_decay) == (ours.rho, ours.momentum, ours.weight_decay)
    assert (d.rho, d.momentum, d.weight_decay) == (ours.d_rho, ours.d_momentum,
                                                   ours.d_weight_decay)
