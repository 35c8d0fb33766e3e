"""``tools/generate.py::generate``, the inference report, on the CPU: PNG mosaics, the
fakes as ``.npy``, and ``summary.txt`` with the means of the enabled metrics.  The
report's numbers are held to the JAX package's metric functions on the same real batches
(the dataset's seeded stream, which both packages share) and the fakes the report wrote:
PSNR, SSIM, MSE, NRMSE and SWD exactly (numpy copies), FID within rtol 1e-3 with the
same random-feature weights in both packages (f32 convs summed in other orders)."""

import os

import numpy as np
import torch

from saragan_tpu.data.dataset import get_numpy_dataset as jax_dataset
from saragan_tpu.metrics import fid as jfid
from saragan_tpu.metrics import skim as jskim
from saragan_tpu.metrics import swd as jswd
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.metrics.fid import RandomConvFeatures
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.tools.generate import generate
from saragan_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)


def test_generate_report_matches_the_reference_metrics(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "data" / "16x16"
    d.mkdir(parents=True)
    for i in range(6):
        np.save(d / f"{i:03d}.npy", rng.normal(size=(16, 16, 16)).astype(np.float32))
    cfg = Config(start_shape="(1, 16, 16, 16)", final_shape="(1, 32, 32, 32)", latent_dim=8,
                 filter_spec=[[8, 8]], starting_phase=1, ending_phase=1, compute_FID=True,
                 compute_swds=True, compute_ssims=True, compute_psnrs=True, compute_mses=True,
                 compute_nrmses=True).finalize()
    params = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=1, cfg=cfg,
                                           device="cpu")
    model = ckpt.save_params(str(tmp_path / "model_1"), params, ema=params)
    jex = jfid.RandomConvFeatures(seed=3, out_dim=32)
    jex._build()
    extractor = RandomConvFeatures.from_numpy({k: np.asarray(v) for k, v in jex._params.items()},
                                              device="cpu")
    out = tmp_path / "report"
    report = generate("pgan", str(tmp_path / "data"), model, str(out), cfg=cfg, phase=1,
                      num_samples=4, batch_size=2, seed=5, device="cpu", extractor=extractor)
    assert sorted(os.listdir(out)) == sorted(
        [f"{k}_{b:04d}.png" for k in ("real", "fake") for b in (0, 1)]
        + [f"fake_{b:04d}_{j}.npy" for b in (0, 1) for j in (0, 1)] + ["summary.txt"])
    for b in (0, 1):
        assert (out / f"real_{b:04d}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    lines = (out / "summary.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["fid", "swd", "psnr", "ssim", "mse", "nrmse"]
    assert {ln.split(":")[0]: float(ln.split(":")[1]) for ln in lines} == report

    reals = jax_dataset(1, 1, cfg.start_shape, str(tmp_path / "data"), None, seed=5)
    sums = {k: [] for k in report}
    for b in (0, 1):
        real = reals.batch(2).astype(np.float32)
        fake = np.stack([np.load(out / f"fake_{b:04d}_{j}.npy")[None] for j in (0, 1)])
        assert fake.shape == real.shape == (2, 1, 16, 16, 16) and np.all(np.isfinite(fake))
        sums["fid"].append(jfid.calculate_fid_given_batch_volumes(real, fake, jex,
                                                                  verbose=False))
        sums["swd"].append(jswd.get_swd_for_volumes(real, fake)[-1])
        sums["psnr"].append(jskim.get_psnr(real, fake))
        sums["ssim"].append(float(np.mean(jskim.get_ssim(real, fake))))
        sums["mse"].append(jskim.get_mean_squared_error(real, fake))
        sums["nrmse"].append(jskim.get_normalized_root_mse(real, fake))
    for k, v in sums.items():
        if k == "fid":
            np.testing.assert_allclose(report[k], np.mean(v), rtol=1e-3)
        else:
            assert report[k] == float(np.mean(v)), k


def test_png_writer_round_trips_without_an_image_library(monkeypatch):
    """The port writes PNG with zlib alone (the machine with the card has no image
    library): an imageio decode here gives the pixels back, and the HTTP service's PNG
    response needs no imageio."""
    import sys

    import imageio

    from saragan_tpu_torch.tools.serve import _png_bytes
    from saragan_tpu_torch.train.summaries import grid_to_uint8, image_grid, png_bytes

    img = np.random.default_rng(1).integers(0, 256, (7, 13)).astype(np.uint8)
    assert np.array_equal(imageio.imread(png_bytes(img)), img)
    vols = np.random.default_rng(2).normal(size=(3, 1, 4, 6, 5)).astype(np.float32)
    monkeypatch.setitem(sys.modules, "imageio", None)  # any import of it now fails
    body = _png_bytes(vols)
    monkeypatch.undo()
    assert np.array_equal(imageio.imread(body), grid_to_uint8(image_grid(vols)))
