"""Sampling from a trained generator (counterpart of ``saragan_tpu/tools/generate.py``).

``make_keyed_sampler`` builds the per-sample-keyed sampler the HTTP service runs;
``generate_minimal`` restores G from a checkpoint, samples, inverts the input
normalization and writes ``.npy`` volumes; ``generate`` writes the full report: PNG
mosaics of real and fake batches, the fakes as ``.npy`` and the means of the enabled
metrics (FID, SWD, PSNR, SSIM, MSE, NRMSE) in ``summary.txt``.

Samplers call the family in sampling mode (``train=False``: no style mixing;
truncation where the family applies it) with per-layer noise, as the reference's
samplers hand the generator a key (``saragan_tpu/tools/generate.py:52-55``): the style
families draw it from a ``LayerNoise`` seeded from the sampler's generator, or per row
from the row's own seed.  They run the serving configuration: fused transitions and the
fused bias+act+pixel-norm kernel forced on, f32 end to end, under inference mode and with
cuDNN's TF32 off (``_inference_context``), so the ``direct`` engine's library convs
compute in full f32 like the reference.  Dense layers use ``torch.matmul``, which is
f32 unless the process itself turns on TF32 matmuls.  The conv engine is an explicit
argument.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.config import Config, num_phases_from_shapes
from saragan_tpu_torch.core import filter_params
from saragan_tpu_torch.data import get_numpy_dataset, invert_normalize_numpy, normalize_numpy
from saragan_tpu_torch.metrics import (calculate_fid_given_batch_volumes, get_mean_squared_error,
                                       get_normalized_root_mse, get_psnr, get_ssim,
                                       get_swd_for_volumes)
from saragan_tpu_torch.metrics.fid import default_extractor
from saragan_tpu_torch.metrics.save_metrics import metric_flags
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops.core import CONV_ENGINES, LayerNoise, generator_seed
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train.summaries import grid_to_uint8, image_grid, png_bytes

_FETCH_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _load_generator_params(model_path: str, use_ema: bool, device):
    params, ema, meta = ckpt.load_params(model_path, device)
    src = ema if (use_ema and ema) else params
    return filter_params(src, "generator"), meta


@contextlib.contextmanager
def _inference_context():
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        yield


def _serving_cfg(cfg: Config, fast_inference: bool) -> Config:
    if fast_inference:
        return dataclasses.replace(cfg, fused_transitions=True, use_pallas_fusion=True)
    return cfg


def _check_engine(conv_engine: str):
    if conv_engine not in CONV_ENGINES:
        raise ValueError(f"conv engine {conv_engine!r} not in {CONV_ENGINES}")


def make_volume_sampler(cfg: Config, phase: int, batch_size: int = 4, alpha: float = 0.0,
                        fast_inference: bool = True, device=None,
                        conv_engine: str = "direct"):
    """`gen(g_params, generator: torch.Generator) -> (batch_size, C, ...)` on `device`;
    the latent batch is drawn from the given generator."""
    dev = resolve_device(device)
    _check_engine(conv_engine)
    cfg = _serving_cfg(cfg, fast_inference)
    arch = get_architecture(cfg.architecture)

    def gen(params, generator: torch.Generator) -> torch.Tensor:
        with _inference_context():
            z = torch.randn((batch_size, cfg.latent_dim), generator=generator, device=dev)
            return arch.generator(params, z, alpha, phase=phase, cfg=cfg,
                                  conv_engine=conv_engine, train=False,
                                  noise=LayerNoise(generator_seed(generator)))

    return gen


def make_keyed_sampler(cfg: Config, phase: int, batch_size: int = 4, alpha: float = 0.0,
                       fast_inference: bool = True, fetch_dtype=None, device=None,
                       conv_engine: str = "direct"):
    """`gen(g_params, seeds (B,), idxs (B,)) -> (B, C, ...)` tensor on `device`.

    Row j depends ONLY on (seeds[j], idxs[j]): its latent comes from its own
    ``torch.Generator`` seeded with ``(seed & 0xffffffff) << 32 | (idx & 0xffffffff)``,
    a style family's noise from a ``LayerNoise`` of the same per-row seeds, and no op of
    the forward mixes rows, so a sample is bit-identical whether its request is served
    alone or micro-batched with others in the same batch size.  JAX's threefry bits are
    not reproduced.

    `device` may be a list of devices (data-parallel serving, the counterpart of the
    reference's sampler over a 1-axis mesh): the parameters are replicated on each (once
    per parameter dict), device i computes rows [i B/n, (i + 1) B/n) and the rows come
    back concatenated in order on the first device.  `batch_size` must divide by their
    count.

    `fetch_dtype` ("float16"/"bfloat16") casts the output on the device before the
    caller fetches it: half the device->host bytes, about 3 decimal digits kept."""
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    if not devices:
        raise ValueError("no device to serve on")
    devs = [resolve_device(d) for d in devices]
    if batch_size % len(devs):
        raise ValueError(f"batch size {batch_size} does not split over {len(devs)} devices")
    _check_engine(conv_engine)
    cfg = _serving_cfg(cfg, fast_inference)
    arch = get_architecture(cfg.architecture)
    out_dtype = _FETCH_DTYPES[fetch_dtype] if isinstance(fetch_dtype, str) else fetch_dtype
    rows_per = batch_size // len(devs)
    replicas = {}  # the last parameter dict's copies, one per device

    def on_devices(params):
        if replicas.get("of") is not params:
            replicas.clear()
            replicas["of"] = params  # held, so its id cannot be reused while cached
            replicas["copies"] = [{k: v.to(d) for k, v in params.items()} for d in devs]
        return replicas["copies"]

    def rows(params, dev, seeds, idxs):
        row_seeds = [((int(s) & 0xFFFFFFFF) << 32) | (int(j) & 0xFFFFFFFF)
                     for s, j in zip(seeds, idxs)]
        z = torch.cat([torch.randn((1, cfg.latent_dim), device=dev,
                                   generator=torch.Generator(dev).manual_seed(r))
                       for r in row_seeds])
        out = arch.generator(params, z, alpha, phase=phase, cfg=cfg, conv_engine=conv_engine,
                             train=False, noise=LayerNoise(row_seeds))
        return out if out_dtype is None else out.to(out_dtype)

    def gen(params, seeds, idxs) -> torch.Tensor:
        if len(seeds) != batch_size or len(idxs) != batch_size:
            raise ValueError(f"sampler built for batch {batch_size}, got {len(seeds)} seeds "
                             f"and {len(idxs)} indices")
        with _inference_context():
            if len(devs) == 1:
                return rows(params, devs[0], seeds, idxs)
            parts = [rows(p, d, seeds[i * rows_per:(i + 1) * rows_per],
                          idxs[i * rows_per:(i + 1) * rows_per])
                     for i, (p, d) in enumerate(zip(on_devices(params), devs))]
            return torch.cat([t.to(devs[0]) for t in parts])

    return gen


def sample_volumes(cfg: Config, phase: int, g_params, num_samples: int, seed: int = 0,
                   batch_size: int = 4, alpha: float = 0.0, fast_inference: bool = True,
                   device=None, conv_engine: str = "direct", _sampler=None) -> np.ndarray:
    """`num_samples` volumes as float32 numpy, batch by batch from one seeded stream."""
    dev = resolve_device(device)
    gen = _sampler if _sampler is not None else make_volume_sampler(
        cfg, phase, batch_size, alpha, fast_inference, dev, conv_engine)
    generator = torch.Generator(dev).manual_seed(seed)
    out = []
    while sum(b.shape[0] for b in out) < num_samples:
        out.append(gen(g_params, generator).float().cpu().numpy())
    return np.concatenate(out)[:num_samples]


def generate_minimal(architecture: str, model_path: str, output_dir: str, *, cfg: Config,
                     phase: Optional[int] = None, num_samples: int = 8, seed: int = 0,
                     data_mean: Optional[float] = None, data_stddev: Optional[float] = None,
                     use_ema: bool = True, device=None, conv_engine: str = "direct") -> list:
    """Restore G, sample, un-normalize, write one ``fake_XXXX.npy`` per volume."""
    dev = resolve_device(device)
    phase = phase or cfg.ending_phase
    g_params, _ = _load_generator_params(model_path, use_ema, dev)
    fakes = sample_volumes(cfg, phase, g_params, num_samples, seed, device=dev,
                           conv_engine=conv_engine)
    fakes = invert_normalize_numpy(fakes, data_mean, data_stddev)
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, vol in enumerate(fakes):
        path = os.path.join(output_dir, f"fake_{i:04d}.npy")
        np.save(path, vol[0])  # channel axis dropped, as the reference dumps
        paths.append(path)
    return paths


def _save_png(path: str, grid: np.ndarray):
    """An image_grid mosaic as an 8-bit grayscale PNG, min-max scaled."""
    with open(path, "wb") as f:
        f.write(png_bytes(grid_to_uint8(grid)))


def generate(architecture: str, dataset_path: str, model_path: str, output_dir: str, *,
             cfg: Config, phase: Optional[int] = None, num_samples: int = 16,
             batch_size: int = 4, seed: int = 0,
             compute_metrics: Optional[Dict[str, bool]] = None, use_ema: bool = True,
             device=None, conv_engine: str = "direct", extractor=None) -> Dict[str, float]:
    """The inference report (the reference's generate.py:20-221): per batch of
    `batch_size` real volumes of the phase's dataset and as many fakes, PNG mosaics
    ``real_XXXX.png`` / ``fake_XXXX.png``, the fakes un-normalized as
    ``fake_XXXX_j.npy``, and the enabled metrics; their means over the batches go to
    ``summary.txt`` and are returned.  FID uses `extractor`, else the one ``cfg`` names
    (``inception_weights``, or with ``allow_uncalibrated_fid`` the random features), on
    `device` (CUDA unless named)."""
    dev = resolve_device(device)
    phase = phase or cfg.ending_phase
    g_params, _ = _load_generator_params(model_path, use_ema, dev)
    os.makedirs(output_dir, exist_ok=True)
    real_ds = get_numpy_dataset(phase, cfg.starting_phase, cfg.start_shape, dataset_path,
                                None, seed=seed)
    compute_metrics = compute_metrics or metric_flags(cfg)
    if compute_metrics.get("compute_FID") and extractor is None:
        extractor = default_extractor(allow_uncalibrated=cfg.allow_uncalibrated_fid,
                                      npz_path=cfg.inception_weights, device=dev)

    sums: Dict[str, list] = {k: [] for k in ("fid", "swd", "psnr", "ssim", "mse", "nrmse")}
    sampler = make_volume_sampler(cfg, phase, batch_size, device=dev, conv_engine=conv_engine)
    done = batch_i = 0
    while done < num_samples:
        n = min(batch_size, num_samples - done)
        real = normalize_numpy(real_ds.batch(n), cfg.data_mean, cfg.data_stddev).astype(
            np.float32)
        fake = sample_volumes(cfg, phase, g_params, n, seed + batch_i, batch_size=batch_size,
                              device=dev, _sampler=sampler)

        _save_png(os.path.join(output_dir, f"real_{batch_i:04d}.png"), image_grid(real))
        _save_png(os.path.join(output_dir, f"fake_{batch_i:04d}.png"), image_grid(fake))
        for j, vol in enumerate(fake):
            np.save(os.path.join(output_dir, f"fake_{batch_i:04d}_{j}.npy"),
                    invert_normalize_numpy(vol[0], cfg.data_mean, cfg.data_stddev))

        if compute_metrics.get("compute_FID"):
            sums["fid"].append(calculate_fid_given_batch_volumes(real, fake, extractor,
                                                                 verbose=False))
        if compute_metrics.get("compute_swds") and real.ndim == 5 and real.shape[-1] >= 16:
            swd = get_swd_for_volumes(real, fake)
            if swd is not None:
                sums["swd"].append(swd[-1])
        if compute_metrics.get("compute_psnrs"):
            sums["psnr"].append(get_psnr(real, fake))
        if compute_metrics.get("compute_ssims") and min(real.shape[2:]) >= 16:
            sums["ssim"].append(float(np.mean(get_ssim(real, fake))))
        if compute_metrics.get("compute_mses"):
            sums["mse"].append(get_mean_squared_error(real, fake))
        if compute_metrics.get("compute_nrmses"):
            sums["nrmse"].append(get_normalized_root_mse(real, fake))
        done += n
        batch_i += 1

    report = {k: float(np.mean(v)) for k, v in sums.items() if v}
    with open(os.path.join(output_dir, "summary.txt"), "w") as f:
        for k, v in report.items():
            f.write(f"{k}: {v}\n")
    return report


def add_model_args(p: argparse.ArgumentParser):
    """The flags that rebuild the generator's Config (shared with tools.serve)."""
    p.add_argument("--phase", type=int, default=None)
    p.add_argument("--latent_dim", type=int, default=256)
    p.add_argument("--start_shape", default="(1, 1, 4, 4)")
    p.add_argument("--final_shape", default="(1, 128, 512, 512)")
    p.add_argument("--network_size", default="xs")
    p.add_argument("--data_mean", type=float, default=None)
    p.add_argument("--data_stddev", type=float, default=None)
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--conv_engine", default="direct", choices=CONV_ENGINES,
                   help="direct: cuDNN conv; flat: the hand-written CUDA conv kernel")


def config_from_args(args) -> Config:
    return Config(
        architecture=args.architecture,
        start_shape=args.start_shape,
        final_shape=args.final_shape,
        latent_dim=args.latent_dim,
        network_size=args.network_size,
        starting_phase=args.phase or 1,
        ending_phase=args.phase,
        data_mean=args.data_mean,
        data_stddev=args.data_stddev,
        **{k: getattr(args, k) for k in _METRIC_FIELDS if hasattr(args, k)},
    ).finalize()


# the report's fields of Config that tools.generate's flags set
_METRIC_FIELDS = ("compute_FID", "compute_swds", "compute_ssims", "compute_psnrs",
                  "compute_mses", "compute_nrmses", "inception_weights",
                  "allow_uncalibrated_fid")  # metric_flags' fields and the extractor's


def config_from_cli(args) -> Config:
    """generate's Config.  Without ``--config_args``: its model flags
    (``config_from_args``).  With them: the training CLI's parser
    (``saragan_tpu_torch.cli.build_parser``) reads ``[architecture, dataset_path]``, then
    generate's model and metric flags as defaults, then ``--config_args``, which override
    them, and ``cli.config_from_args(...).finalize()`` builds the Config, so every flag
    that shapes the generator (``--first_conv_nfilters``, ``--kernel_spec``,
    ``--filter_spec``, ``--activation``, ...) rebuilds it as it was trained."""
    if not args.config_args:
        return config_from_args(args)
    from saragan_tpu_torch import cli

    ending = args.phase or num_phases_from_shapes(args.start_shape, args.final_shape)
    argv = [args.architecture, args.dataset_path, "--start_shape", args.start_shape,
            "--final_shape", args.final_shape, "--latent_dim", str(args.latent_dim),
            "--starting_phase", str(args.phase or 1), "--ending_phase", str(ending),
            "--noise_stddev", "0"]
    if args.network_size is not None:
        argv += ["--network_size", args.network_size]
    for name in ("data_mean", "data_stddev", "inception_weights"):
        if getattr(args, name) is not None:
            argv += [f"--{name}", str(getattr(args, name))]
    argv += [f"--{name}" for name in _METRIC_FIELDS
             if name != "inception_weights" and getattr(args, name)]
    train_args = cli.build_parser().parse_args(argv + list(args.config_args))
    return cli.config_from_args(train_args).finalize()


def main(argv=None):
    """python -m saragan_tpu_torch.tools.generate <arch> <dataset> <model> <out> [--minimal]
    [--compute_FID --allow_uncalibrated_fid | --inception_weights NPZ] [--compute_swds] ...
    [--config_args <training CLI flags>...]"""
    p = argparse.ArgumentParser(prog="saragan_tpu_torch.tools.generate")
    p.add_argument("architecture")
    p.add_argument("dataset_path", help="the npy pyramid the report's real volumes come from")
    p.add_argument("model_path")
    p.add_argument("output_dir")
    p.add_argument("--config_args", nargs=argparse.REMAINDER, default=[],
                   help="the rest of the command line goes to the training CLI's parser "
                        "(the flags that rebuild the generator as it was trained)")
    add_model_args(p)
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--minimal", action="store_true", help="generate_minimal mode")
    for m in ("FID", "swds", "ssims", "psnrs", "mses", "nrmses"):
        p.add_argument(f"--compute_{m}", default=False, action="store_true")
    p.add_argument("--inception_weights", default=None,
                   help="converted pt_inception-2015-12-05 npz for calibrated FID")
    p.add_argument("--allow_uncalibrated_fid", default=False, action="store_true",
                   help="FID over random conv features when no Inception weights are given")
    args = p.parse_args(argv)
    cfg = config_from_cli(args)
    if args.minimal:
        paths = generate_minimal(
            args.architecture, args.model_path, args.output_dir, cfg=cfg, phase=args.phase,
            num_samples=args.num_samples, seed=args.seed, data_mean=cfg.data_mean,
            data_stddev=cfg.data_stddev, use_ema=not args.no_ema, device=args.device,
            conv_engine=args.conv_engine)
        print(f"wrote {len(paths)} volumes to {args.output_dir}")
        return
    report = generate(args.architecture, args.dataset_path, args.model_path, args.output_dir,
                      cfg=cfg, phase=args.phase, num_samples=args.num_samples,
                      batch_size=args.batch_size, seed=args.seed, use_ema=not args.no_ema,
                      device=args.device, conv_engine=args.conv_engine)
    print(report)


if __name__ == "__main__":
    main()
