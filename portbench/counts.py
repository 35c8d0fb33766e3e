"""Operations and bytes of the convs and dense layers a configuration's step needs.

The reference step runs on the ``meta`` device at the cell's shapes under ``Counter``, a
dispatch mode that books every call that reaches it:

* ``aten.convolution``: 2 x multiply-adds (output elements x input channels per group x
  kernel taps; for a transposed conv, input elements x output channels per group x
  taps), bytes of its input, weight and output;
* ``aten.convolution_backward``: its data gradient and its weight gradient, each as many
  operations as the forward, with the bytes of (grad_output, weight, grad_input) and of
  (input, grad_output, grad_weight);
* ``aten.mm`` / ``aten.addmm`` / ``aten.bmm``: 2 m n k, bytes of both operands and the
  result.

The growing transition (nearest upscale, then a SAME conv) and its two gradients book
themselves as the polyphase conv they equal (``counting.transition``: 2 taps along a
3-tap axis, the coarse input), and keep the library calls inside them from being booked
again.  The forward, both gradients and the penalty's double backward are all counted,
as the reference's autograd asks for them, and no recompute is.  Bytes count each input,
weight and output of a call once, in the element size given (the cell's compute dtype).
So the same work is counted whatever implements it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import counting

aten = torch.ops.aten


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def conv_macs(x_shape, w_shape, out_shape, transposed: bool) -> int:
    taps = _numel(w_shape[2:])
    if transposed:  # weight (Cin, Cout / groups, *k): each input element scatters
        return _numel(x_shape) * int(w_shape[1]) * taps
    return _numel(out_shape) * int(w_shape[1]) * taps  # weight (Cout, Cin / groups, *k)


class Counter(TorchDispatchMode):
    """Books operations and elements per kind of call; ``calls`` keeps each call as
    (kind, flops, elements)."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[str, int, int]] = []
        self._suppress = 0

    def book(self, kind: str, flops: int, elements: int):
        self.calls.append((kind, int(flops), int(elements)))

    @contextlib.contextmanager
    def suppressed(self):
        self._suppress += 1
        try:
            yield
        finally:
            self._suppress -= 1

    def __enter__(self):
        counting.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        counting.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._suppress:
            return out
        packet = func.overloadpacket
        if packet is aten.convolution:
            x, w, transposed = args[0], args[1], bool(args[6])
            macs = conv_macs(x.shape, w.shape, out.shape, transposed)
            self.book("conv", 2 * macs, x.numel() + w.numel() + out.numel())
        elif packet is aten.convolution_backward:
            gy, x, w = args[0], args[1], args[2]
            transposed, mask = bool(args[7]), args[10]
            macs = conv_macs(x.shape, w.shape, gy.shape, transposed)
            if mask[0]:
                self.book("conv_dgrad", 2 * macs, gy.numel() + w.numel() + x.numel())
            if mask[1]:
                self.book("conv_wgrad", 2 * macs, x.numel() + gy.numel() + w.numel())
        elif packet in (aten.mm, aten.bmm):
            a, b = args[0], args[1]
            self.book("dense", 2 * a.numel() * int(b.shape[-1]),
                      a.numel() + b.numel() + out.numel())
        elif packet is aten.addmm:
            a, b = args[1], args[2]
            self.book("dense", 2 * a.numel() * int(b.shape[-1]),
                      a.numel() + b.numel() + out.numel())
        return out

    def totals(self, elem_bytes: int) -> Dict[str, float]:
        """{"flops", "bytes"} over every call."""
        return {"flops": float(sum(f for _, f, _ in self.calls)),
                "bytes": float(sum(e for _, _, e in self.calls) * elem_bytes)}

    def roofline_s(self, elem_bytes: int, peak_flops: float, peak_bytes_s: float):
        """(seconds, {"compute": calls bound by compute, "bytes": by bandwidth}): the sum
        over calls of max(flops / peak, bytes / bandwidth)."""
        total, bound = 0.0, {"compute": 0, "bytes": 0}
        for _, flops, elements in self.calls:
            tc, tb = flops / peak_flops, elements * elem_bytes / peak_bytes_s
            total += max(tc, tb)
            bound["compute" if tc >= tb else "bytes"] += 1
        return total, bound


def _meta(shape):
    return torch.zeros(shape, device="meta")


def train_step_counter(cfg: dict, phase: int, batch: int, fading: bool) -> Counter:
    """The calls of one reference train step (the mixing half when `fading`, else the
    stabilizing half at alpha 0) at batch `batch`, counted on the meta device."""
    from portbench.reference import train as rt

    shapes = rt.param_shapes(cfg, phase)
    base = cfg["base_shape"]
    spatial = [d * 2 ** (phase - 1) for d in base[1:]]
    real = _meta((batch, base[0], *spatial))
    noise = (lambda name, shape: _meta(shape)) if cfg["architecture"] == "surfgan" else None
    draws = rt.Draws(z=_meta((batch, cfg["latent_dim"])), gamma=_meta((batch,)),
                     z_mix=_meta((batch, cfg["latent_dim"])),
                     mix_coin=_meta(()), mix_cutoff=torch.zeros((), dtype=torch.long,
                                                                 device="meta"),
                     refresh_z=_meta((64, cfg["latent_dim"])), noise=noise)
    params = {k: _meta(s) for k, s in shapes.items()}
    alpha = torch.zeros((), device="meta") if fading else 0.0
    counter = Counter()
    with counter:
        rt.losses_and_grads(params, real, draws, alpha, cfg=cfg, phase=phase)
    return counter

