"""The port's network smoke test (``saragan_tpu_torch/tools/test_network.py``) against the
JAX package's: for each of the six families at phase 2 (every one trains one phase, as
stylegan2 must), the port's output shapes, G/D parameter counts and per-variable listing
(names and shapes, the reference's print format) equal the reference's, and its two train
steps give finite losses; both CLIs print the same listing and totals; and every entry
point this slice adds raises without a GPU unless it is given the CPU."""

import io
import contextlib
import math

import jax
import numpy as np
import pytest
import torch

from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.tools import test_network as ref_net
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.tools import test_network

torch.set_num_threads(1)

FAMILIES = ("pgan", "pgan2", "pgandeep", "stylegan", "stylegan2", "surfgan")
PHASE, LATENT, BATCH = 2, 16, 2
ARGV = ["--phase", str(PHASE), "--latent_dim", str(LATENT), "--network_size", "xxs",
        "--batch_size", str(BATCH)]
# the CLIs at phase 1: the reference's jit of the train step is the cost of this file
CLI_ARGV = ["--phase", "1"] + ARGV[2:]
# the fields both CLIs' main set (start (1, 4, 4, 4), final doubled per phase)
CFG = dict(start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)", starting_phase=PHASE,
           ending_phase=PHASE, latent_dim=LATENT, network_size="xxs", base_batch_size=BATCH,
           loss_fn="wgan", noise_stddev=0.0, g_lr=1e-3, d_lr=1e-3)


def _listing_line(name, shape):
    return f"{int(np.prod(shape)):>12}  {name}  {tuple(shape)}"


def _reference_shapes(name):
    """The reference's listing, counts and output shapes, from shapes alone
    (``jax.eval_shape`` of its init, generator and discriminator)."""
    cfg = JaxConfig(architecture=name, **CFG).finalize()
    arch = jax_arch(name)
    params = jax.eval_shape(lambda k: arch.init(k, phase=PHASE, cfg=cfg), jax.random.PRNGKey(0))
    z = jax.ShapeDtypeStruct((BATCH, LATENT), np.float32)
    img = jax.eval_shape(lambda p, z: arch.generator(p, z, 0.5, phase=PHASE, cfg=cfg,
                                                     rng=jax.random.PRNGKey(2)), params, z)
    score = jax.eval_shape(lambda p, x: arch.discriminator(p, x, 0.5, phase=PHASE, cfg=cfg),
                           params, img)
    count = {p: sum(int(np.prod(v.shape)) for k, v in params.items() if k.startswith(p))
             for p in ("generator", "discriminator")}
    return ([_listing_line(k, params[k].shape) for k in sorted(params)], count,
            tuple(img.shape), tuple(score.shape))


def _listing(out: str):
    return [line for line in out.splitlines() if "  " in line and "/" in line
            and line.strip().split()[0].isdigit()]


@pytest.mark.parametrize("name", FAMILIES)
def test_smoke_test_matches_reference_shapes_and_counts(name, capsys):
    listing, count, img_shape, score_shape = _reference_shapes(name)
    cfg = Config(architecture=name, **CFG).finalize()
    report = test_network.run_smoke_test(name, PHASE, cfg, BATCH, device="cpu")
    assert _listing(capsys.readouterr().out) == listing
    assert report["generator_params"] == count["generator"]
    assert report["discriminator_params"] == count["discriminator"]
    assert report["generator_output_shape"] == img_shape == (BATCH, 1, 8, 8, 8)
    assert report["discriminator_output_shape"] == score_shape
    assert math.isfinite(report["gen_loss"]) and math.isfinite(report["disc_loss"])
    assert report["conv_engine"] == "direct" and report["device"] == "cpu"
    assert report["device_bytes_in_use"] is None


def test_cli_prints_the_reference_listing_and_report(capsys):
    """Both CLIs on pgan at phase 1: the same variable listing and totals; the port's
    report has the reference's keys."""
    with contextlib.redirect_stdout(io.StringIO()) as ref_out:
        ref_report = None
        real = ref_net.run_smoke_test

        def keep(*a, **k):
            nonlocal ref_report
            ref_report = real(*a, **k)
            return ref_report

        ref_net.run_smoke_test = keep
        try:
            ref_net.main(["pgan"] + CLI_ARGV)
        finally:
            ref_net.run_smoke_test = real
    report = test_network.main(["pgan"] + CLI_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    want = ref_out.getvalue()
    assert _listing(out) == _listing(want) and len(_listing(out)) > 10
    totals = [line for line in out.splitlines() if line.startswith(("Generator output",
                                                                   "Total "))]
    assert totals == [line for line in want.splitlines()
                      if line.startswith(("Generator output", "Total "))]
    assert set(ref_report) <= set(report)
    for key in ("generator_output_shape", "discriminator_output_shape", "generator_params",
                "discriminator_params", "architecture", "phase"):
        assert report[key] == ref_report[key], key


def _entry_points(tmp_path):
    """Each new entry point called without a device."""
    from saragan_tpu_torch.tools import export_model, prepare_data
    from saragan_tpu_torch.tools.serve import GeneratorService

    cfg = Config(architecture="pgan", **CFG).finalize()
    return {
        "test_network.main": lambda: test_network.main(["pgan"] + ARGV),
        "export_generator": lambda: export_model.export_generator(cfg, PHASE, {}),
        "load_exported": lambda: export_model.load_exported(str(tmp_path / "g.pt2")),
        "from_artifact": lambda: GeneratorService.from_artifact(str(tmp_path / "g.pt2")),
        "create_dataset": lambda: prepare_data.create_dataset([], str(tmp_path)),
        "process_volume": lambda: prepare_data.process_volume(np.zeros((2, 2, 2))),
    }


@pytest.mark.parametrize("entry", ["test_network.main", "export_generator", "load_exported",
                                   "from_artifact", "create_dataset", "process_volume"])
def test_entry_point_without_a_device_raises_on_a_gpu_less_host(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(tmp_path)[entry]()
