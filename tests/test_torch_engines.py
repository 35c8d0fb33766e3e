"""The op formulations as explicit options (``ops.core.Ops``): every conv engine, pool and
statistics choice of the port against the JAX package's function with its process-wide
gate set (``monkeypatch``), on the CPU; then the flagship's step under each engine against
the port's own ``direct`` step, a JAX step under ``s2d`` against the port's, the kernel
calls of the ``flat_v2`` step, and ``resolve_ops`` against ``apply_runtime_opts``.

Tolerances, of the reference's largest magnitude: f64 1e-10, f32 1e-5, bf16 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import saragan_tpu.ops.core as jcore
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu_torch import losses
from saragan_tpu_torch.config import Config, resolve_ops
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import conv3d_s2d as s2d
from saragan_tpu_torch.ops import core as ops
from saragan_tpu_torch.ops.conv3d_gemm import shifted_gemm
from saragan_tpu_torch.ops.conv3d_grad import Conv3dW
from saragan_tpu_torch.train.step import make_grads_fn

torch.set_num_threads(1)

LIMIT = {np.float64: 1e-10, np.float32: 1e-5, ml_dtypes.bfloat16: 1e-2}
KERNELS = [(3, 3, 3), (1, 3, 3), (3, 1, 5)]


def _close(ours, ref, dtype, what=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(ours - ref).max()
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    assert err <= LIMIT[dtype] * scale, f"{what}: max|diff| {err} of max {scale}"


def _arrays(kernel, c=4, f=6, spatial=(4, 6, 8), n=2, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, *spatial)).astype(dtype)
    w = (rng.normal(size=(*kernel, c, f)) / np.sqrt(c * np.prod(kernel))).astype(dtype)
    ct = rng.normal(size=(n, f, *spatial)).astype(dtype)
    return x, w, ct


def _t(a, grad=False):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).requires_grad_(grad)
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().double().numpy() if t.dtype != torch.bfloat16 else t.detach().float().numpy()


def _jax_three(conv, x, w, ct, upcast=False):
    """(y, dx, dw, the penalty's d/dw of sum((d/dx sum(tanh(C(x, w))))^2)) in JAX;
    `upcast`: bf16 values in f32 (XLA:CPU has no bf16 x bf16 -> f32 dot, which the
    reference's GEMM formulations ask for: it runs them on the same values in f32)."""
    if upcast:
        x, w, ct = (np.asarray(a, np.float32) for a in (x, w, ct))
    y, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(ct))

    def up(v):  # bf16 sums in f32
        return v.astype(jnp.promote_types(v.dtype, jnp.float32))

    def inner(ww):
        g = jax.grad(lambda xx: jnp.sum(jnp.tanh(up(conv(xx, ww)))))(jnp.asarray(x))
        return jnp.sum(jnp.square(up(g)))

    return [np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
            for v in (y, dx, dw, jax.grad(inner)(jnp.asarray(w)))]


def _torch_three(conv, x, w, ct):
    xt, wt = _t(x, True), _t(w, True)
    y = conv(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(ct))
    xt, wt = _t(x, True), _t(w, True)
    up = lambda v: v.float() if v.dtype == torch.bfloat16 else v  # noqa: E731
    (g,) = torch.autograd.grad(torch.tanh(up(conv(xt, wt))).sum(), xt, create_graph=True)
    (gw,) = torch.autograd.grad(torch.square(up(g)).sum(), wt)
    return [_np(v) for v in (y, dx, dw, gw)]


def _check_three(ours, ref, dtype, what):
    for name, a, b in zip(("forward", "dx", "dw", "second order"), ours, ref):
        _close(a, b, dtype, f"{what} {name}")


def _engine(name, **kw):
    return lambda x, w: ops.conv_apply(x, w, ops.Ops(name, **kw))


# ---------------------------------------------------------------------------
# The conv engines against their JAX functions: forward, VJP, the penalty's second order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS + [(1, 1, 1)])
def test_gemm_matches_shifted_gemm(kernel, dtype):
    """``gemm``: per-offset GEMMs into one f32 accumulator, autograd's backward; the JAX
    package's ``_conv3d_shifted_gemm`` (its 1x1x1 path too: a skinny mul-sum)."""
    x, w, ct = _arrays(kernel, dtype=dtype)
    _check_three(_torch_three(_engine("gemm"), x, w, ct),
                 _jax_three(jcore._conv3d_shifted_gemm, x, w, ct, True), dtype,
                 f"gemm {kernel}")


@pytest.mark.parametrize("c,f", [(1, 16), (40, 8)], ids=["c1", "wide"])
def test_gemm_1x1_paths_match(c, f):
    """The 1x1x1 formulation's two other paths: C = 1 (a product) and C > 32 (a GEMM)."""
    x, w, ct = _arrays((1, 1, 1), c=c, f=f, seed=1)
    _check_three(_torch_three(_engine("gemm"), x, w, ct),
                 _jax_three(jcore._conv3d_shifted_gemm, x, w, ct), np.float32, "1x1")


def test_gemm_terms_are_not_rounded_before_the_sum():
    """bf16 operands whose exact products sum to an f32 value no bf16 partial sum keeps:
    the port's one f32 accumulator rounds once, so it equals the f32 conv of the same
    bf16 values rounded once."""
    x, w, _ = _arrays((3, 3, 3), c=16, f=8, dtype=ml_dtypes.bfloat16, seed=2)
    ours = shifted_gemm(_t(x), _t(w))
    exact = F.conv3d(_t(x).double(), _t(w).double().permute(4, 3, 0, 1, 2), padding=1)
    assert torch.equal(ours, exact.float().to(torch.bfloat16)) or (
        (ours.double() - exact).abs().max() <= 2 ** -8 * exact.abs().max())


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_hybrid_matches_jax(kernel, dtype):
    """``hybrid``: the GEMM forward, the direct conv's gradients (the reference's
    ``custom_jvp`` of direct convs)."""
    x, w, ct = _arrays(kernel, dtype=dtype, seed=3)
    _check_three(_torch_three(_engine("hybrid"), x, w, ct),
                 _jax_three(jcore._conv3d_hybrid, x, w, ct, True), dtype, f"hybrid {kernel}")


def test_hybrid_differentiates_its_own_backward_f64():
    """grad(grad(D(x), x)): the backward recorded under create_graph is differentiable,
    gradcheck and gradgradcheck in f64 and the penalty's pattern against the direct conv."""
    x, w, ct = _arrays((3, 3, 3), c=2, f=3, spatial=(3, 4, 4), n=1, seed=4, dtype=np.float64)
    hybrid = _engine("hybrid")
    assert torch.autograd.gradcheck(hybrid, (_t(x, True), _t(w, True)))
    assert torch.autograd.gradgradcheck(hybrid, (_t(x, True), _t(w, True)))
    ours = _torch_three(hybrid, x, w, ct)
    ref = _torch_three(_engine("direct"), x, w, ct)
    _check_three(ours, ref, np.float64, "hybrid f64 against direct")


@pytest.mark.parametrize("wgrad,jax_wgrad", [("library", "xla"), ("einsum", "einsum")])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", [(3, 1, 3), (1, 1, 1)])
def test_gemm_custom_matches_conv3d_c(monkeypatch, kernel, dtype, wgrad, jax_wgrad):
    """``gemm_custom``: the C/W algebra over the scan GEMM, W the library's weight
    gradient or per-offset GEMMs (``SARAGAN_CONV3D_WGRAD``); 1x1x1 with C, F <= 32 the
    skinny mul-sum wgrad."""
    monkeypatch.setattr(jcore, "CONV3D_ALGORITHM", "gemm_custom")
    monkeypatch.setenv("SARAGAN_CONV3D_WGRAD", jax_wgrad)
    x, w, ct = _arrays(kernel, dtype=dtype, seed=5)
    ours = _torch_three(_engine("gemm_custom", wgrad=wgrad), x, w, ct)
    _check_three(ours, _jax_three(jcore._conv3d_C, x, w, ct, True), dtype,
                 f"gemm_custom {wgrad}")
    # W alone and its own VJP (the penalty's second order re-enters C through it)
    dy = ct
    uw = np.random.default_rng(6).normal(size=w.shape).astype(dtype)
    ref, vjp = jax.vjp(lambda a, b: jcore._conv3d_W(a, b, kernel),
                       jnp.asarray(x, jnp.float32), jnp.asarray(dy, jnp.float32))
    rdx, rddy = vjp(jnp.asarray(uw, jnp.float32))
    xt, dyt = _t(x, True), _t(dy, True)
    dw = Conv3dW.apply(xt, dyt, kernel, ("gemm_custom", wgrad, "f32"))
    dx, ddy = torch.autograd.grad(dw, (xt, dyt), _t(uw))
    for name, a, b in (("W", dw, ref), ("dx", dx, rdx), ("ddy", ddy, rddy)):
        _close(_np(a), np.asarray(b, np.float32), dtype, f"W {wgrad} {name}")


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
def test_flat_v2_matches_conv3d_c_under_pallas2(monkeypatch, dtype):
    """``flat_v2``: C is kernel #3 (here its plain version) for forward and dgrad, W the
    library's weight gradient, as the reference's ``_conv3d_C`` under ``pallas2`` (its
    kernel in interpret mode) with ``_conv3d_W``'s ``xla`` wgrad."""
    monkeypatch.setattr(jcore, "CONV3D_ALGORITHM", "pallas2")
    x, w, ct = _arrays((3, 3, 3), c=2, f=3, spatial=(3, 4, 4), n=1, dtype=dtype, seed=7)
    before = (cf.conv3d_flat_v2_plain.calls, cf.conv3d_flat_plain.calls,
              cf.conv3d_flat_wgrad_plain.calls)
    ours = _torch_three(_engine("flat_v2"), x, w, ct)
    _check_three(ours, _jax_three(jcore._conv3d_C, x, w, ct), dtype, "flat_v2")
    # forward, dgrad and the second order's convs through #3, none through #1 or #2
    assert cf.conv3d_flat_v2_plain.calls > before[0]
    assert (cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls) == before[1:]


# ---------------------------------------------------------------------------
# s2d
# ---------------------------------------------------------------------------


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("kernel,c,spatial", [((5, 5, 5), 4, (4, 4, 6)),
                                              ((3, 1, 5), 2, (4, 6, 8)),
                                              ((1, 3, 3), 1, (2, 4, 4))])
def test_s2d_matches_jax_f64(x64, kernel, c, spatial):
    x, w, ct = _arrays(kernel, c=c, f=5, spatial=spatial, dtype=np.float64, seed=8)
    _check_three(_torch_three(_engine("s2d"), x, w, ct),
                 _jax_three(jcore._conv3d_s2d, x, w, ct), np.float64, f"s2d {kernel}")


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
def test_s2d_matches_jax(dtype):
    x, w, ct = _arrays((3, 3, 3), c=8, f=8, spatial=(4, 4, 8), dtype=dtype, seed=9)
    _check_three(_torch_three(_engine("s2d"), x, w, ct),
                 _jax_three(jcore._conv3d_s2d, x, w, ct), dtype, "s2d")


def test_s2d_fold_round_trip_and_weight_matches_jax():
    x = torch.randn(2, 3, 4, 6, 8)
    assert torch.equal(s2d.s2d_unfold(s2d.s2d_fold(x)), x)
    np.testing.assert_array_equal(s2d.s2d_fold(x).numpy(),
                                  np.asarray(jcore._s2d_fold(jnp.asarray(x.numpy()))))
    w = np.random.default_rng(10).normal(size=(3, 1, 5, 2, 3)).astype(np.float32)
    ours, pads = s2d.s2d_fold_weight(torch.from_numpy(w))
    ref, ref_pads = jcore._s2d_fold_weight(jnp.asarray(w))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert pads == ref_pads


@pytest.mark.parametrize("max_cin", [16, 4])
def test_s2d_applicability_matches_jax_plus_odd_kernels(monkeypatch, max_cin):
    monkeypatch.setattr(jcore, "_S2D_MAX_CIN", max_cin)
    cases = [((1, 8, 4, 4, 4), (3, 3, 3)), ((1, 8, 4, 4, 4), (1, 1, 1)),
             ((1, 8, 4, 5, 4), (3, 3, 3)), ((1, 20, 4, 4, 4), (3, 3, 3)),
             ((1, 4, 4, 4, 4), (1, 3, 3)), ((1, 2, 2, 4, 4), (3, 3, 3))]
    for xs, k in cases:
        x, w = torch.zeros(xs), torch.zeros(*k, xs[1], 8)
        ref = jcore._s2d_applicable(jnp.zeros(xs), jnp.zeros((*k, xs[1], 8)))
        assert s2d.s2d_applicable(x, w, max_cin) == ref, (xs, k)
    # an even kernel the reference's rule accepts: the port takes the direct conv
    assert jcore._s2d_applicable(jnp.zeros((1, 4, 4, 4, 4)), jnp.zeros((2, 3, 3, 4, 8)))
    assert not s2d.s2d_applicable(torch.zeros(1, 4, 4, 4, 4), torch.zeros(2, 3, 3, 4, 8), 16)


def test_s2d_even_kernel_equals_direct_where_the_reference_diverges():
    """The reference's frozen fault (ADVICE.md): its ``_conv3d_s2d`` pads k // 2 before
    each axis, SAME only for odd k, so an even kernel diverges from the direct conv; the
    port's ``s2d`` gives such a conv to the direct conv."""
    x, w, _ = _arrays((2, 3, 3), c=4, f=4, spatial=(4, 4, 4), seed=11)
    ours = ops.conv_apply(_t(x), _t(w), "s2d")
    assert torch.equal(ours, ops.conv_apply(_t(x), _t(w), "direct"))
    ref = np.asarray(jcore._conv3d_s2d(jnp.asarray(x), jnp.asarray(w)))
    direct = np.asarray(jcore._conv_direct(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(_np(ours), direct, rtol=1e-5, atol=1e-5)
    assert np.abs(ref - direct).max() > 0.1 * np.abs(direct).max()


# ---------------------------------------------------------------------------
# Pooling and statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("stats", ["f32", "compute"])
@pytest.mark.parametrize("pool", ["reshape", "window"])
def test_avg_pool_matches_jax_gates(monkeypatch, pool, stats, dtype):
    """``avg_pool`` and ``pixel_norm`` against the reference with ``POOL_WINDOW`` and
    ``STATS_ACCUM_F32`` set.  The window's slices are summed one after another in the
    accumulation dtype, as the reference's ``reduce_window``; the port's reductions (the
    reshape's mean, the channel mean) accumulate in f32 inside and round once to the
    dtype asked for, while the reference's XLA:CPU sums a bf16 reduction in bf16 (0.6-1.2 %
    of max from its own f32 route on these inputs), hence the bf16 limit."""
    monkeypatch.setattr(jcore, "POOL_WINDOW", pool == "window")
    monkeypatch.setattr(jcore, "STATS_ACCUM_F32", stats == "f32")
    engine = ops.Ops(pool=pool, stats=stats)
    rng = np.random.default_rng(12)
    for c in (8, 16):
        x = rng.normal(size=(2, c, 4, 8, 8)).astype(dtype)
        _close(_np(ops.avg_pool(_t(x), engine=engine)), np.asarray(jcore.avg_pool(x), np.float32),
               dtype, f"avg_pool C={c}")
        _close(_np(ops.pixel_norm(_t(x), engine=engine)),
               np.asarray(jcore.pixel_norm(jnp.asarray(x)), np.float32), dtype,
               f"pixel_norm C={c}")


@pytest.mark.parametrize("pool", ["reshape", "window"])
def test_avg_pool_second_order_f64(pool):
    """The penalty reaches the pool: gradgradcheck, and both forms equal in f64."""
    x = torch.randn(1, 2, 2, 4, 4, dtype=torch.float64, requires_grad=True)
    engine = ops.Ops(pool=pool)
    assert torch.autograd.gradgradcheck(lambda t: ops.avg_pool(t, engine=engine), (x,))
    torch.testing.assert_close(ops.avg_pool(x, engine=engine), ops.avg_pool(x), rtol=1e-15,
                               atol=1e-15)


@pytest.mark.parametrize("stats", ["f32", "compute"])
def test_skinny_1x1_statistics_match_jax(monkeypatch, stats):
    """The skinny 1x1x1 conv's channel sum and wgrad under ``stats`` in f32 (the same
    math either way) against the reference's ``_conv3d_shifted_gemm`` and
    ``_wgrad_mulsum_1x1``."""
    monkeypatch.setattr(jcore, "STATS_ACCUM_F32", stats == "f32")
    x, w, ct = _arrays((1, 1, 1), c=8, f=4, seed=13)
    y = ops.conv_apply(_t(x), _t(w), ops.Ops("gemm", stats=stats))
    _close(_np(y), np.asarray(jcore._conv3d_shifted_gemm(jnp.asarray(x), jnp.asarray(w))),
           np.float32, "1x1")
    dw = Conv3dW.apply(_t(x), _t(ct), (1, 1, 1), ("gemm_custom", "library", stats))
    _close(_np(dw), np.asarray(jcore._wgrad_mulsum_1x1(jnp.asarray(x), jnp.asarray(ct))),
           np.float32, "1x1 wgrad")


def test_ops_value_validates_and_names_mean_defaults():
    assert ops.as_ops("s2d") == ops.Ops(conv="s2d")
    assert ops.as_ops(ops.Ops("gemm", pool="window")).pool == "window"
    for bad in (dict(conv="pallas2"), dict(wgrad="xla"), dict(pool="max"),
                dict(stats="bf16"), dict(s2d_max_cin=0)):
        with pytest.raises(ValueError):
            ops.Ops(**bad)
    with pytest.raises(ValueError, match="conv engine"):
        ops.conv_apply(torch.zeros(1, 1, 2, 2, 2), torch.zeros(1, 1, 1, 1, 1), "winograd")
    with pytest.raises(ValueError, match="odd kernels"):
        ops.conv_apply(torch.zeros(1, 1, 4, 4, 4), torch.zeros(2, 3, 3, 1, 1), "gemm")
    hash(ops.Ops())


# ---------------------------------------------------------------------------
# The step under each engine
# ---------------------------------------------------------------------------

STEP = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 8, 32, 32)",
            latent_dim=16, filter_spec=[[16, 16], [16, 8], [8, 8]], loss_fn="wgan",
            gp_weight=10.0, adam_beta1=0.0, adam_beta2=0.9)
STEP_PHASE, STEP_N = 3, 2
ENGINES = [ops.Ops("flat_v2"), ops.Ops("gemm"), ops.Ops("gemm_custom"),
           ops.Ops("gemm_custom", wgrad="einsum"), ops.Ops("hybrid"), ops.Ops("s2d"),
           ops.Ops("flat", pool="window", stats="compute")]


@pytest.fixture(scope="module")
def f64_step_direct():
    """The phase-3 step's f64 gradients under ``direct`` (parameters, batch and draws in
    f64), and its inputs."""
    cfg = Config(**STEP, compute_dtype="float64").finalize()
    arch = get_architecture("pgan")
    params = arch.init(torch.Generator().manual_seed(0), phase=STEP_PHASE, cfg=cfg,
                       device="cpu")
    params = {k: v.double() for k, v in params.items()}
    g_p = {k: v for k, v in params.items() if k.startswith("generator")}
    d_p = {k: v for k, v in params.items() if k.startswith("discriminator")}
    real = torch.randn(cfg.current_shape(STEP_PHASE, STEP_N), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(1))
    draws = losses.draw_inputs(torch.Generator().manual_seed(2), STEP_N, cfg.latent_dim,
                               real.shape[1:], torch.float64, "cpu")
    inputs = (g_p, d_p, real, draws, 0.5)
    return cfg, inputs, make_grads_fn(arch, cfg, STEP_PHASE, conv_engine="direct")(*inputs)


@pytest.mark.parametrize("engine", ENGINES, ids=lambda o: f"{o.conv}-{o.wgrad}-{o.pool}")
def test_phase3_step_f64_under_each_engine_equals_direct(f64_step_direct, engine):
    cfg, inputs, ((rg, rd), rout) = f64_step_direct
    (gg, gd), out = make_grads_fn(get_architecture("pgan"), cfg, STEP_PHASE,
                                  conv_engine=engine)(*inputs)
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        _close(getattr(out, name).numpy(), getattr(rout, name).numpy(), np.float64, name)
    for ours, ref in ((gg, rg), (gd, rd)):
        assert ours.keys() == ref.keys()
        for k in ref:
            _close(ours[k].numpy(), ref[k].numpy(), np.float64, k)


def test_jax_step_under_s2d_matches_the_ports(monkeypatch):
    """The JAX package's TPU training default, ``s2d``, in one phase-3 f32 step of its
    jitted train step from one converted state, against the port's step under ``s2d``."""
    from saragan_tpu.models import get_architecture as jax_arch
    from saragan_tpu.train import init_train_state as jax_init
    from saragan_tpu.train import make_train_step as jax_step
    from saragan_tpu_torch.convert import train_state_from_numpy, train_state_to_numpy
    from saragan_tpu_torch.optim.factory import make_optimizers_from_config
    from saragan_tpu_torch.train.step import make_train_step

    monkeypatch.setattr(jcore, "CONV3D_ALGORITHM", "s2d")
    jcfg, cfg = JaxConfig(**STEP).finalize(), Config(**STEP).finalize()
    state, (jgo, jdo) = jax_init(jax_arch("pgan"), jax.random.PRNGKey(0), phase=STEP_PHASE,
                                 cfg=jcfg)
    tree = {p: {k: np.asarray(v) for k, v in getattr(state, p).items()}
            for p in ("g_params", "d_params", "ema")}
    for p in ("g_opt", "d_opt"):
        o = getattr(state, p)
        tree[p] = {"count": np.asarray(o.count), "mu": {k: np.asarray(v) for k, v in o.mu.items()},
                   "nu": {k: np.asarray(v) for k, v in o.nu.items()}}
    real = np.random.default_rng(3).normal(size=cfg.current_shape(STEP_PHASE, STEP_N))
    real = real.astype(np.float32)
    key = jax.random.PRNGKey(4)
    new, jm = jax.jit(jax_step(jax_arch("pgan"), jcfg, STEP_PHASE, jgo, jdo))(
        state, jnp.asarray(real), key, 0.5, 1e-3, 1e-3)
    k_z, _, _, _, k_gamma = jax.random.split(key, 5)
    draws = losses.Draws(
        _t(jax.random.normal(k_z, (STEP_N, cfg.latent_dim))),
        _t(jax.random.uniform(k_gamma, (STEP_N, 1, 1, 1, 1))), None, None)
    go, do = make_optimizers_from_config(cfg)
    step = make_train_step(get_architecture("pgan"), cfg, STEP_PHASE, go, do,
                           conv_engine="s2d")
    calls, folded = [], ops.conv3d_s2d  # the folded conv runs: count its calls
    monkeypatch.setattr(ops, "conv3d_s2d", lambda x, w: calls.append(x.shape) or folded(x, w))
    tnew, m = step(train_state_from_numpy(tree, "cpu"), torch.from_numpy(real), None, 0.5,
                   1e-3, 1e-3, draws=draws)
    assert calls, "no conv took the folded form"
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        np.testing.assert_allclose(_np(getattr(m, name)), np.asarray(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    ours = train_state_to_numpy(tnew)
    for part in ("g_params", "d_params", "ema"):
        for k, v in getattr(new, part).items():
            np.testing.assert_allclose(ours[part][k], np.asarray(v), rtol=1e-3, atol=1e-6,
                                       err_msg=k)


BENCH6 = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 128, 512, 512)",
              latent_dim=256, base_batch_size=8 * 2 ** 5, network_size="xs", loss_fn="wgan",
              gp_weight=10.0, adam_beta1=0.0, adam_beta2=0.9, compute_dtype="bfloat16",
              use_pallas_fusion=True)


def test_flat_v2_step_calls_kernel_3_where_flat_calls_kernel_1():
    """The flagship step (phase 6, batch 8, shapes only on the meta device) under
    ``flat_v2``: kernel #3 is called as often as #1 is under ``flat`` (28 forward + 39
    dgrad), #1 and #2 never; the weight gradients take the library's."""
    from saragan_tpu_torch.train.step import init_train_state, make_train_step

    cfg = Config(**BENCH6).finalize()
    arch = get_architecture("pgan")
    counts = {}
    for engine in ("flat", "flat_v2"):
        state, (go, do) = init_train_state(arch, torch.Generator().manual_seed(0), phase=6,
                                           cfg=cfg, device="meta")
        real = torch.empty(cfg.current_shape(6, 8), device="meta")
        draws = losses.draw_inputs(None, 8, cfg.latent_dim, real.shape[1:], torch.float32,
                                   "meta")
        fns = (cf.conv3d_flat_plain, cf.conv3d_flat_v2_plain, cf.conv3d_flat_wgrad_plain)
        before = [f.calls for f in fns]
        make_train_step(arch, cfg, 6, go, do, conv_engine=engine)(state, real, None, 0.5, 1e-3,
                                                                  1e-3, draws=draws)
        counts[engine] = [f.calls - b for f, b in zip(fns, before)]
    assert counts["flat"] == [67, 0, 28]
    assert counts["flat_v2"] == [0, 67, 0]


# ---------------------------------------------------------------------------
# resolve_ops against apply_runtime_opts
# ---------------------------------------------------------------------------

JAX_NAMES = {"pallas": "flat", "pallas2": "flat_v2"}


@pytest.mark.parametrize("preset", [False, True], ids=["plain", "preset"])
@pytest.mark.parametrize("spatial", [False, True], ids=["unsharded", "spatial"])
@pytest.mark.parametrize("inference", [False, True], ids=["train", "inference"])
def test_resolve_ops_matches_apply_runtime_opts(monkeypatch, preset, spatial, inference):
    """On the CPU, unset, every choice of the reference's table; its preset's window pool
    and compute-dtype statistics are the stated difference (the port's preset keeps
    reshape / f32).  Explicit choices, its environment variables, win on both sides."""
    for gate in ("CONV3D_ALGORITHM", "POOL_WINDOW", "STATS_ACCUM_F32"):
        monkeypatch.setattr(jcore, gate, getattr(jcore, gate))  # restored after the test
    for var in ("SARAGAN_CONV3D", "SARAGAN_POOL", "SARAGAN_STATS_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    jcfg = JaxConfig(single_chip_big_volume=preset).finalize()
    cfg = Config(single_chip_big_volume=preset).finalize()
    jcfg.apply_runtime_opts(spatial=spatial, inference=inference)
    o = resolve_ops(cfg, "cpu", inference=inference, spatial=spatial)
    assert o.conv == JAX_NAMES.get(jcore.CONV3D_ALGORITHM, jcore.CONV3D_ALGORITHM)
    assert (jcore.POOL_WINDOW, not jcore.STATS_ACCUM_F32) == (preset, preset)
    assert (o.pool, o.stats) == ("reshape", "f32")
    # on a CUDA device the port trains on flat where the reference's TPU picks s2d
    cuda = resolve_ops(cfg, "cuda", inference=inference, spatial=spatial).conv
    assert cuda == ("flat" if preset or not inference else "direct")
    # explicit: the environment there, the fields here
    monkeypatch.setenv("SARAGAN_CONV3D", "gemm_custom")
    monkeypatch.setenv("SARAGAN_POOL", "window")
    monkeypatch.setenv("SARAGAN_STATS_DTYPE", "compute")
    jcfg.apply_runtime_opts(spatial=spatial, inference=inference)
    o = resolve_ops(dataclasses.replace(cfg, conv_engine="gemm_custom", pool="window",
                                        stats_dtype="compute"), "cuda", inference, spatial)
    assert (o.conv, o.pool, o.stats) == (jcore.CONV3D_ALGORITHM, "window", "compute")
    assert (jcore.POOL_WINDOW, jcore.STATS_ACCUM_F32) == (True, False)
