"""The port's ``parallel/`` in one process (its multi-process behaviour is
``tests/test_torch_multiprocess.py``): the mesh of one rank, whose collectives are
identities, the data-parallel step and trainer at world size 1 bit-equal to the plain
ones, each rank's rows of the global draws, the row-split keyed sampler, the options that
still raise (ROADMAP.md queue 1 item 16), the CLI's parity flags, the checkpoint writer's
per-process temporary names, and ``batch_sharded`` against the JAX package's.

Small shapes (latent 16, 8 filters, phase <= 2) with ``torch.set_num_threads(1)``."""

import os

import numpy as np
import pytest
import torch

from saragan_tpu.data.dataset import NumpyPathDataset as JaxNumpyPathDataset
from saragan_tpu_torch import cli, losses
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.data.dataset import NumpyPathDataset
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops.core import NoiseByName, RankRowsNoise, conv_apply
from saragan_tpu_torch.parallel import (Mesh, allreduce_mean_, allreduce_min, any_rank,
                                        broadcast_json, broadcast_params_, broadcast_scalar,
                                        gather_rows, halo_conv3d, init_mesh, shard_rows,
                                        synchronized_trial)
from saragan_tpu_torch.tools.generate import make_keyed_sampler
from saragan_tpu_torch.tools.serve import serve_devices
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train.step import init_train_state, make_train_step
from saragan_tpu_torch.train.trainer import Trainer
from tests.test_torch_trainer import make_data

torch.set_num_threads(1)

SMALL = dict(start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)", latent_dim=16,
             network_size="xxs", kernel_spec=[[[], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
             filter_spec=[[8, 8], [8, 8]], loss_fn="wgan", gp_weight=10.0,
             adam_beta1=0.0, adam_beta2=0.9, noise_stddev=0.0)


@pytest.fixture
def mesh():
    """A group of one on the CPU (no launcher in the environment)."""
    m = init_mesh("cpu", verbose=False)
    yield m
    m.close()


def fake_mesh(rank, world):
    """A mesh's coordinates without a group, for what needs no collective."""
    return Mesh(None, None, torch.device("cpu"), rank, world, "gloo")


def test_mesh_of_one_and_its_collectives(mesh):
    """Rank 0 of 1 over gloo; every collective is exact at world size 1 (the mean divides
    by 1), the control broadcasts pass through."""
    assert (mesh.rank, mesh.world_size, mesh.backend, mesh.transport) == (0, 1, "gloo",
                                                                          "device")
    g = torch.Generator().manual_seed(0)
    t = {"b/w": torch.randn(3, 4, generator=g), "a/w": torch.randn(5, generator=g),
         "c/h": torch.randn(2, 2, generator=g).to(torch.bfloat16)}
    ref = {k: v.clone() for k, v in t.items()}
    allreduce_mean_(t, mesh)
    broadcast_params_(t, mesh)
    for k in ref:
        assert t[k].dtype == ref[k].dtype and torch.equal(t[k], ref[k]), k
    x = torch.randn(4, 3, generator=g, requires_grad=True)
    assert shard_rows(x, mesh) is x and gather_rows(x, mesh) is x
    assert torch.equal(allreduce_min(x.detach(), mesh), x.detach())
    assert broadcast_scalar(0.1 + 0.2, mesh) == 0.1 + 0.2
    assert broadcast_json({"a": [1]}, mesh) == {"a": [1]}
    assert any_rank(True, mesh) and not any_rank(False, mesh)
    trial = object()
    assert synchronized_trial(trial, mesh) is trial and synchronized_trial(None, mesh) is None


def test_rank_rows_of_the_global_draws():
    """A rank's draws are its rows of the global batch's: the per-sample draws by
    ``shard_rows``, the noise source's rows of its global draw, the style-mixing coin,
    cutoff and the refresh latents shared."""
    g = torch.Generator().manual_seed(1)
    d = losses.draw_inputs(g, 6, 16, (1, 4, 4, 4), torch.float32, "cpu", noise_stddev=0.1,
                           style_phase=2)
    for rank in range(3):
        m = fake_mesh(rank, 3)
        r = losses.shard_draws(d, m)
        rows = slice(2 * rank, 2 * rank + 2)
        for f in losses.ROW_DRAWS:
            assert torch.equal(getattr(r, f), getattr(d, f)[rows]), f
        for f in ("mix_coin", "mix_cutoff", "refresh_z"):
            assert getattr(r, f) is getattr(d, f), f
        assert isinstance(r.noise, RankRowsNoise)
        assert torch.equal(r.noise("a/apply_noise", (2, 1, 4, 4, 4), torch.float32, "cpu"),
                           d.noise("a/apply_noise", (6, 1, 4, 4, 4), torch.float32, "cpu")[rows])
    by_name = NoiseByName({"x": torch.arange(12.0).reshape(6, 2)})
    assert torch.equal(RankRowsNoise(by_name, 1, 2)("x", (3, 2), torch.float32, "cpu"),
                       torch.arange(6.0, 12.0).reshape(3, 2))
    assert losses.shard_draws(d, None) is d
    with pytest.raises(ValueError, match="do not split"):
        shard_rows(torch.zeros(5), fake_mesh(0, 2))


@pytest.mark.parametrize("arch,extra", [
    ("pgan", {}), ("surfgan", {}),
    ("pgan", dict(optim_strategy="alternate", gradient_accumulation=2))],
    ids=["pgan", "surfgan", "pgan-alternate-accumulate"])
def test_dp_step_at_world_one_equals_plain_step(mesh, arch, extra):
    """The step over a mesh of one (its all-reduce, the draws' rows, the gathered
    minibatch-stddev statistic) is bit-equal to the plain step from the same state and
    generator: parameters, optimizer slots, EMA and every reported value."""
    cfg = Config(**SMALL, architecture=arch, starting_phase=2, ending_phase=2,
                 **extra).finalize()
    a = get_architecture(arch)
    state, opts = init_train_state(a, torch.Generator().manual_seed(0), phase=2, cfg=cfg,
                                   device="cpu")
    real = torch.from_numpy(np.random.default_rng(3).normal(
        size=cfg.current_shape(2, 4)).astype(np.float32))
    out = []
    for m in (None, mesh):
        step = make_train_step(a, cfg, 2, *opts, conv_engine="flat", mesh=m)
        new, metrics = step(state, real, torch.Generator().manual_seed(5), 0.5, 1e-3, 1e-3)
        out.append((new, metrics))
    (p, pm), (d, dm) = out
    for part in ("g_params", "d_params", "ema"):
        for k, v in getattr(p, part).items():
            assert torch.equal(getattr(d, part)[k], v), (part, k)
    for o1, o2 in ((p.g_opt, d.g_opt), (p.d_opt, d.d_opt)):
        assert o1.count == o2.count
        for s, tree in o1.slots.items():
            assert all(torch.equal(o2.slots[s][k], v) for k, v in tree.items()), s
    for f in ("gen_loss", "disc_loss", "gp_loss", "max_g_norm", "max_d_norm", "fake_min",
              "fake_max"):
        assert torch.equal(getattr(pm, f), getattr(dm, f)), f


def _trainer_cfg(tmp_path, name, **kw):
    return Config(**SMALL, architecture="pgan", dataset_path=str(tmp_path / "data"),
                  starting_phase=1, ending_phase=2, base_batch_size=4, mixing_nimg=8,
                  stabilizing_nimg=8, checkpoint_every_nsteps=10_000, g_lr=1e-3, d_lr=1e-3,
                  validation_fraction=0.2, test_fraction=0.2, grad_histograms=False,
                  logdir=str(tmp_path / name), **kw).finalize()


@pytest.mark.parametrize("native", [True, False], ids=["native", "thread"])
def test_trainer_over_a_mesh_of_one_equals_the_plain_trainer(tmp_path, mesh, native):
    """Phase 1 -> 2 through ``Trainer(mesh=...)`` at world size 1 (the sharded loader on
    the C++ prefetcher or the Python thread, the broadcast state, the all-reduced step, the
    agreed interrupt flag) ends bit-equal to the plain trainer, with a global size of 1."""
    make_data(tmp_path / "data")
    plain = Trainer(_trainer_cfg(tmp_path, "plain", native_prefetch=native), device="cpu",
                    verbose=False)
    plain.run()
    dp = Trainer(_trainer_cfg(tmp_path, "dp", native_prefetch=native), mesh=mesh,
                 verbose=False)
    dp.run()
    assert dp.global_size == 1 and dp.device == torch.device("cpu")
    for part in ("g_params", "d_params", "ema"):
        for k, v in getattr(plain.state, part).items():
            assert torch.equal(getattr(dp.state, part)[k], v), (part, k)
    with pytest.raises(ValueError, match="mesh's"):
        Trainer(_trainer_cfg(tmp_path, "x"), mesh=fake_mesh(0, 1), device="meta")


def test_spatial_sharding_raises_naming_item_16(tmp_path, mesh):
    """``--num_space_shards`` / ``--num_space2_shards`` above 1 raise, with or without
    ``--horovod``, naming ROADMAP.md's item 16; so do the Trainer and the mesh."""
    make_data(tmp_path / "data", sizes=(4,))
    argv = ["pgan", str(tmp_path / "data"), "--start_shape", "(1, 4, 4, 4)",
            "--final_shape", "(1, 8, 8, 8)", "--starting_phase", "1", "--ending_phase", "1",
            "--latent_dim", "16", "--noise_stddev", "0", "--g_lr", "1e-3", "--d_lr", "1e-3",
            "--base_batch_size", "4", "--device", "cpu", "--logdir", str(tmp_path / "r")]
    for extra in (["--num_space_shards", "2"], ["--num_space2_shards", "2", "--horovod"],
                  ["--num_space_shards", "2", "--horovod"]):
        with pytest.raises(NotImplementedError, match="queue 1 item 16"):
            cli.main(argv + extra)
    with pytest.raises(NotImplementedError, match="item 16"):
        Trainer(_trainer_cfg(tmp_path, "t", num_space_shards=2), mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 16"):
        init_mesh("cpu", num_space2=4)
    with pytest.raises(ValueError, match="world size 1"):
        cli.main(argv + ["--horovod", "--num_data_shards", "2"])


def test_parity_flags_and_data_parallel_options_parse():
    """The reference's no-op flags are accepted; the data axis parses."""
    args = cli.build_parser().parse_args([
        "pgan", "d", "--start_shape", "(1, 4, 4, 4)", "--final_shape", "(1, 8, 8, 8)",
        "--starting_phase", "1", "--ending_phase", "1", "--latent_dim", "16",
        "--noise_stddev", "0", "--use_adasum", "--gpu", "--num_inter_ops", "8", "--horovod",
        "--num_data_shards", "4"])
    cfg = cli.config_from_args(args)
    assert cfg.use_adasum and cfg.horovod and cfg.num_data_shards == 4
    assert (cfg.num_space_shards, cfg.num_space2_shards) == (1, 1)
    assert args.gpu and args.num_inter_ops == 8


def test_checkpoint_temporary_names_are_per_process(tmp_path, monkeypatch):
    """Ranks sharing a logdir never write one temporary file: each name carries the
    writer's pid, and the file lands whole under its final name."""
    renamed = []
    real_replace = os.replace

    def replace(src, dst):
        renamed.append((str(src), str(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(ckpt.os, "replace", replace)
    cfg = Config(**SMALL, architecture="pgan", starting_phase=1, ending_phase=1).finalize()
    state, _ = init_train_state(get_architecture("pgan"), torch.Generator().manual_seed(0),
                                phase=1, cfg=cfg, device="cpu")
    ckpt.save_params(str(tmp_path / "m"), state.g_params)
    ckpt.save_full_state(str(tmp_path / "m_full"), state, {"global_step": 0})
    assert renamed == [(str(tmp_path / f"m.npz.{os.getpid()}.tmp"), str(tmp_path / "m.npz")),
                       (str(tmp_path / f"m_full.pkl.{os.getpid()}.tmp"),
                        str(tmp_path / "m_full.pkl"))]
    assert sorted(os.listdir(tmp_path)) == ["m.npz", "m_full.pkl"]


def test_batch_sharded_matches_the_reference(tmp_path):
    """Every shard draws the global batch's paths from the shared stream and loads its
    [shard::shards]: the JAX package's shards on the same files and seed, each volume once
    per global batch."""
    for i in range(8):
        np.save(tmp_path / f"v{i}.npy", np.full((2, 4, 4), float(i), np.float32))
    seen = []
    for shard in range(2):
        ours = NumpyPathDataset(str(tmp_path), None, seed=7)
        ref = JaxNumpyPathDataset(str(tmp_path), None, seed=7)
        for _ in range(3):
            a, b = ours.batch_sharded(2, 2, shard), ref.batch_sharded(2, 2, shard)
            np.testing.assert_array_equal(a, b)
        seen.append(ours)
    a0 = NumpyPathDataset(str(tmp_path), None, seed=7).batch_sharded(2, 2, 0)[:, 0, 0, 0, 0]
    a1 = NumpyPathDataset(str(tmp_path), None, seed=7).batch_sharded(2, 2, 1)[:, 0, 0, 0, 0]
    assert not set(a0) & set(a1)
    np.testing.assert_array_equal(
        NumpyPathDataset(str(tmp_path), None, seed=7).batch_sharded(4, 1, 0),
        NumpyPathDataset(str(tmp_path), None, seed=7).batch(4))


@pytest.mark.parametrize("arch", ["pgan", "surfgan"])
def test_keyed_sampler_row_split_is_bit_equal_to_one_device(arch):
    """Rows split over [cpu, cpu] (parameters replicated once, each row keyed by its own
    seed) give one device's batch bit for bit; a batch that does not split, and more
    devices than cards, raise."""
    cfg = Config(**SMALL, architecture=arch, starting_phase=2, ending_phase=2).finalize()
    params = get_architecture(arch).init(torch.Generator().manual_seed(0), phase=2, cfg=cfg,
                                         device="cpu")
    g = {k: v for k, v in params.items() if k.startswith("generator/")}
    seeds, idxs = np.array([3, 3, 7, -1]), np.array([0, 1, 0, 5])
    one = make_keyed_sampler(cfg, 2, 4, device="cpu", conv_engine="flat")(g, seeds, idxs)
    split = make_keyed_sampler(cfg, 2, 4, device=["cpu", "cpu"], conv_engine="flat")
    assert torch.equal(split(g, seeds, idxs), one)
    assert torch.equal(split(g, seeds, idxs), one)  # the replicas cached
    with pytest.raises(ValueError, match="does not split"):
        make_keyed_sampler(cfg, 2, 3, device=["cpu", "cpu"])


def test_default_backend(monkeypatch):
    """gloo on the CPU and where a host's ranks share the card named for them all
    (torchrun's LOCAL_WORLD_SIZE above 1), which NCCL refuses; else nccl."""
    from saragan_tpu_torch.parallel.mesh import default_backend

    cuda = torch.device("cuda", 0)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert default_backend(torch.device("cpu"), True) == "gloo"
    assert default_backend(cuda, False) == default_backend(cuda, True) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert default_backend(cuda, True) == "gloo" and default_backend(cuda, False) == "nccl"


def test_serve_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert serve_devices(cpu, 1) == [cpu] and serve_devices(cpu, 3) == [cpu] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--serve_devices 2 > 1 available"):
        serve_devices(torch.device("cuda"), 2)
    with pytest.raises(ValueError, match="< 1"):
        serve_devices(cpu, 0)


def test_halo_conv_at_world_one(mesh):
    """One rank holds the whole depth: both engines are the SAME conv (zero slabs at both
    ends); the conv refuses autograd (its backward is item 16) and even depth kernels."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 6, 5, 4, generator=g, dtype=torch.float64)
    for kd in (1, 3, 5):
        w = torch.randn(kd, 3, 3, 3, 4, generator=g, dtype=torch.float64)
        ref = conv_apply(x, w, "direct")
        for engine in ("direct", "flat"):
            torch.testing.assert_close(halo_conv3d(x, w, mesh, engine=engine), ref,
                                       rtol=0, atol=1e-12)
    with pytest.raises(NotImplementedError, match="item 16"):
        halo_conv3d(x.requires_grad_(True), w, mesh)
    with pytest.raises(ValueError, match="odd"):
        halo_conv3d(x.detach(), torch.zeros(2, 3, 3, 3, 4, dtype=torch.float64), mesh)
