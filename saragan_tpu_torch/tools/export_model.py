"""Serving export: the trained generator as one self-contained ``torch.export`` program
(counterpart of ``saragan_tpu/tools/export_model.py``, whose artifact is StableHLO; that
format has no PyTorch loader, so the port's artifact is a ``.pt2`` file of
``torch.export.save``).

The program holds the generator at a fixed phase and batch, its parameters baked in by
default, as ATen operators only: any process with PyTorch loads and calls it without
this package, its model code or the checkpoint file:

    blob = export_generator(cfg, phase, g_params, batch_size=8)
    save_exported("g.pt2", blob)
    ...
    gen = load_exported("g.pt2")                      # -> callable(z) -> volumes
    volumes = gen(np.random.randn(8, latent_dim).astype(np.float32))

With ``bake_params=False`` the program takes (params, z) instead, so one program serves
many checkpoints (e.g. EMA vs raw weights).

As in the reference (``saragan_tpu/tools/export_model.py:30-37``), the artifact runs the
plain path: fused transitions, no fused bias+act+pixel-norm kernel and the ``direct``
(cuDNN) conv whatever the config's engine, so it holds no hand-written kernel and stays
self-contained; the checkpoint service keeps the kernels.  A style family's per-layer
noise is drawn once at export from `seed` and baked in, as the reference fixes its noise
key at export.  The program is traced on the device it will serve on (the CUDA device
unless named) under ``torch.no_grad``; ``load_exported`` moves one traced elsewhere and
runs it under the checkpoint path's numerics (deterministic cuDNN, no TF32).
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import numpy as np
import torch

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops.core import LayerNoise, NoiseByName


def _on(params, dev: torch.device) -> dict:
    """{name: tensor on `dev`} from numpy arrays or tensors."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))).to(dev)
            for k, v in params.items()}


class _RecordedNoise:
    """A ``LayerNoise`` that keeps every tensor it draws, by layer name."""

    def __init__(self, seed: int):
        self._source = LayerNoise(seed)
        self.tensors = {}

    def __call__(self, name, shape, dtype, device):
        self.tensors[name] = self._source(name, shape, torch.float32, device)
        return self.tensors[name].to(dtype)


class _Generator(torch.nn.Module):
    """G at one phase with its noise (and, baked, its parameters) as buffers."""

    def __init__(self, arch, cfg, phase, alpha, params, noise, bake_params):
        super().__init__()
        self._arch, self._cfg, self._phase, self._alpha = arch, cfg, phase, alpha
        self._noise_names = list(noise)
        for i, name in enumerate(self._noise_names):
            self.register_buffer(f"noise_{i}", noise[name])
        self._param_names = list(params) if bake_params else None
        for i, name in enumerate(self._param_names or ()):
            self.register_buffer(f"param_{i}", params[name])

    def _run(self, params, z):
        noise = NoiseByName({n: getattr(self, f"noise_{i}")
                             for i, n in enumerate(self._noise_names)})
        return self._arch.generator(params, z, self._alpha, phase=self._phase, cfg=self._cfg,
                                    conv_engine="direct", train=False, noise=noise)

    def forward(self, *args):
        if self._param_names is None:
            params, z = args
            return self._run(params, z)
        (z,) = args
        return self._run({n: getattr(self, f"param_{i}")
                          for i, n in enumerate(self._param_names)}, z)


def _export_cfg(cfg: Config, fast_inference: bool) -> Config:
    # the fused bias+act+pixel-norm kernel is never traced into an artifact (a ctypes
    # call on raw pointers; the reference keeps its Pallas kernels out the same way)
    cfg = dataclasses.replace(cfg, use_pallas_fusion=False)
    return dataclasses.replace(cfg, fused_transitions=True) if fast_inference else cfg


def export_generator(
    cfg: Config,
    phase: int,
    g_params,
    batch_size: int = 8,
    alpha: float = 0.0,
    seed: int = 0,
    bake_params: bool = True,
    fast_inference: bool = True,
    device=None,
) -> bytes:
    """G at a fixed phase and batch as a ``torch.export`` program (``.pt2`` bytes),
    traced under the ``direct`` engine on `device` (the CUDA device unless named)."""
    dev = resolve_device(device)
    cfg = _export_cfg(cfg, fast_inference)
    arch = get_architecture(cfg.architecture)
    params = _on(g_params, dev)
    z = torch.zeros((batch_size, cfg.latent_dim), device=dev)
    noise = _RecordedNoise(seed)  # the style families' noise, drawn once from `seed`
    with torch.no_grad():
        arch.generator(params, z, alpha, phase=phase, cfg=cfg, conv_engine="direct",
                       train=False, noise=noise)
        module = _Generator(arch, cfg, phase, alpha, params, noise.tensors, bake_params)
        args = (z,) if bake_params else (params, z)
        program = torch.export.export(module, args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_exported(path: str, blob: bytes) -> str:
    with open(path, "wb") as f:
        f.write(blob)
    return path


def _program_device(program) -> Optional[torch.device]:
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if node.op == "placeholder" and isinstance(val, torch.Tensor):
            return val.device
    return None


class ExportedGenerator:
    """A loaded artifact: ``gen(z)`` (or ``gen(params, z)`` for an unbaked one) -> the
    volumes, a tensor on `device`; z may be numpy.  ``batch_size`` and ``latent_dim``
    come from the program's input signature; ``takes_params`` says whether it is
    unbaked."""

    def __init__(self, program, device: torch.device):
        if _program_device(program) != device:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, device)
        self.program, self.device = program, device
        users = [s for s in program.graph_signature.input_specs
                 if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
        nodes = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
        z_val = nodes[users[-1].arg.name].meta["val"]
        self.batch_size, self.latent_dim = (int(d) for d in z_val.shape)
        self.takes_params = len(users) > 1
        self._module = program.module()

    def __call__(self, *args):
        *params, z = args
        z = (z if isinstance(z, torch.Tensor) else torch.from_numpy(np.array(z, np.float32)))
        z = z.to(self.device, torch.float32)
        params = [_on(p, self.device) for p in params]
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            return self._module(*params, z)


def load_exported(path: str, device=None) -> ExportedGenerator:
    """A saved artifact -> a callable (no model code needed), on `device` (the CUDA
    device unless named)."""
    dev = resolve_device(device)
    return ExportedGenerator(torch.export.load(path), dev)


def main(argv: Optional[list] = None):
    import argparse

    from saragan_tpu_torch.tools.generate import _load_generator_params

    p = argparse.ArgumentParser(description="Export a trained generator to a torch.export "
                                            "program (.pt2)")
    p.add_argument("architecture")
    p.add_argument("--model_path", required=True, help="checkpoint .npz (model_{phase})")
    p.add_argument("--out", required=True, help="output .pt2 path")
    p.add_argument("--phase", type=int, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--start_shape", default="(1, 1, 4, 4)")
    p.add_argument("--final_shape", default="(1, 128, 512, 512)")
    p.add_argument("--network_size", default="xs")
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--no_bake_params", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device the artifact is traced on and serves on "
                        "(default: cuda)")
    args = p.parse_args(argv)

    cfg = Config(
        architecture=args.architecture,
        start_shape=args.start_shape,
        final_shape=args.final_shape,
        latent_dim=args.latent_dim,
        network_size=args.network_size,
        starting_phase=args.phase,
        ending_phase=args.phase,
    ).finalize()
    dev = resolve_device(args.device)
    g_params, _ = _load_generator_params(args.model_path, not args.no_ema, dev)
    blob = export_generator(cfg, args.phase, g_params, batch_size=args.batch_size,
                            bake_params=not args.no_bake_params, device=dev)
    save_exported(args.out, blob)
    print(f"wrote {args.out} ({len(blob) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
