"""Network smoke test (counterpart of ``saragan_tpu/tools/test_network.py``, the rebuild
of the reference's SURFGAN_3D/networks/test_network.py:12-125): build G and D with their
optimizers for one family at one phase, run two train steps, and print the output shapes,
every variable's shape, the parameter counts, the step times and the device memory.

Usage:
    python -m saragan_tpu_torch.tools.test_network pgan --phase 3 \
        --start_shape '(1, 4, 4, 4)' --latent_dim 64 --network_size xs [--device cpu]

Without ``--device`` it runs on the CUDA device (and raises without one).  The op
formulation is resolved as the trainer resolves it (``config.resolve_ops``): without
``--conv_engine`` the hand-written kernels (``flat``) on the card, cuDNN (``direct``) on
the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.config import CONV_ENGINES, Config, parse_tuple, resolve_ops
from saragan_tpu_torch.core import param_count
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops.core import LayerNoise
from saragan_tpu_torch.train.step import init_train_state, make_train_step


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_smoke_test(architecture: str, phase: int, cfg, batch_size: int = 2,
                   verbose: bool = True, device=None) -> dict:
    """Build, list, run two steps; returns the reference's report (output shapes, G/D
    parameter counts, build / first-step / step seconds, losses, device bytes in use)
    plus the device and the conv engine (``cfg.conv_engine``, resolved for the device)."""
    dev = resolve_device(device)
    engine = resolve_ops(cfg, dev.type)
    arch = get_architecture(architecture)
    t0 = time.perf_counter()
    state, (g_opt, d_opt) = init_train_state(arch, torch.Generator().manual_seed(0),
                                             phase=phase, cfg=cfg, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0

    params = {**state.g_params, **state.d_params}
    if verbose:
        for name in sorted(params):
            print(f"{params[name].numel():>12}  {name}  {tuple(params[name].shape)}")
    n_g = param_count(params, "generator")
    n_d = param_count(params, "discriminator")

    z = torch.randn((batch_size, cfg.latent_dim), generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    with torch.no_grad():
        img = arch.generator(state.g_params, z, 0.5, phase=phase, cfg=cfg,
                             conv_engine=engine, noise=LayerNoise(2))
        score = arch.discriminator(state.d_params, img, 0.5, phase=phase, cfg=cfg,
                                   conv_engine=engine)

    step = make_train_step(arch, cfg, phase, g_opt, d_opt, conv_engine=engine)
    real = torch.randn(img.shape, generator=torch.Generator(dev).manual_seed(3), device=dev)
    t0 = time.perf_counter()
    state2, metrics = step(state, real, torch.Generator(dev).manual_seed(4), 0.5, 1e-3, 1e-3)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state2, metrics = step(state2, real, torch.Generator(dev).manual_seed(5), 0.5, 1e-3, 1e-3)
    _sync(dev)
    step_s = time.perf_counter() - t0

    mem = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    report = {
        "architecture": architecture,
        "phase": phase,
        "generator_output_shape": tuple(img.shape),
        "discriminator_output_shape": tuple(score.shape),
        "generator_params": n_g,
        "discriminator_params": n_d,
        "build_seconds": round(build_s, 3),
        "compile_seconds": round(compile_s, 3),  # the first step (the libraries load)
        "step_seconds": round(step_s, 4),
        "gen_loss": float(metrics.gen_loss),
        "disc_loss": float(metrics.disc_loss),
        "device_bytes_in_use": mem,
        "device": str(dev),
        "conv_engine": engine.conv,
    }
    if verbose:
        print(f"Generator output shape: {report['generator_output_shape']}")
        print(f"Total generator variables: {n_g}")
        print(f"Total discriminator variables: {n_d}")
        print(f"build {build_s:.2f}s  first step {compile_s:.2f}s  step {step_s * 1000:.1f}ms "
              f"({dev}, conv engine {engine})")
        if mem:
            print(f"device memory in use: {mem / 1e6:.1f} MB")
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="saragan_tpu_torch.tools.test_network")
    p.add_argument("architecture")
    p.add_argument("--phase", type=int, default=2)
    p.add_argument("--start_shape", type=str, default="(1, 4, 4, 4)")
    p.add_argument("--final_shape", type=str, default=None)
    p.add_argument("--latent_dim", type=int, default=64)
    p.add_argument("--network_size", type=str, default="xs")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--loss_fn", default="wgan", choices=["wgan", "logistic"])
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--conv_engine", default="unset", choices=list(CONV_ENGINES),
                   help="the 3-D conv formulation; unset: as the trainer resolves it")
    args = p.parse_args(argv)

    start = parse_tuple(args.start_shape)
    final = args.final_shape or str(
        (start[0], *[d * 2 ** max(args.phase, 1) for d in start[1:]])
    )
    cfg = Config(
        architecture=args.architecture,
        start_shape=args.start_shape,
        final_shape=final,
        starting_phase=args.phase,
        ending_phase=args.phase,
        latent_dim=args.latent_dim,
        network_size=args.network_size,
        base_batch_size=args.batch_size,
        loss_fn=args.loss_fn,
        noise_stddev=0.0,
        g_lr=1e-3,
        d_lr=1e-3,
        conv_engine=args.conv_engine,
    ).finalize()
    return run_smoke_test(args.architecture, args.phase, cfg, args.batch_size,
                          device=args.device)


if __name__ == "__main__":
    main()
