"""What a ``torch.profiler`` trace of a few steps or dispatches says, as plain numbers.

``profile(fn)`` runs `fn` under the profiler (host and device) and returns a ``Record``:
each device operation's interval and name (kernels, copies and fills), the host's
operators with their intervals, and the host's launch calls.  From it:

* ``busy_s``: the union of the device intervals; ``window_s``: from the first event to
  the last; the idle share is one minus their ratio;
* ``group_s``: device seconds by ``kernel_group`` (a frozen copy of the port's grouping,
  ``saragan_tpu_torch/tools/profile_training.py``, so a renamed kernel cannot move a
  number between groups);
* ``idle_gaps``: the gaps between device intervals, each named by the innermost host
  operator running when it opened;
* ``launches``: the runtime's cudaLaunchKernel calls and the driver's cuLaunchKernel*
  (copied from ``profile_training.launch_counts``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

CONV_GROUPS = ("conv3d_flat forward+dgrad (tensor cores)", "conv3d_wgrad (tensor cores)",
               "conv3d_flat forward+dgrad (CUDA)", "conv3d_wgrad (CUDA)", "cuDNN convolutions")
GEMM_GROUPS = ("GEMM (cuBLAS)",)


def kernel_group(name: str) -> str:
    """Frozen copy of ``saragan_tpu_torch.tools.profile_training.kernel_group``."""
    if "conv3d_fwd_tc_kernel" in name:
        return "conv3d_flat forward+dgrad (tensor cores)"
    if "wgrad_tc_partial_kernel" in name or "wgrad_tc_reduce_kernel" in name:
        return "conv3d_wgrad (tensor cores)"
    if "conv3d_fwd_kernel" in name:
        return "conv3d_flat forward+dgrad (CUDA)"
    if "wgrad_partial_kernel" in name or "wgrad_reduce_kernel" in name:
        return "conv3d_wgrad (CUDA)"
    if "fused_fwd_kernel" in name:
        return "fused_bias_act_pixelnorm (CUDA)"
    if "fused_bwd_kernel" in name:
        return "fused_bias_act_pixelnorm backward (CUDA)"
    if any(t in name for t in ("xmma", "cudnn", "implicit_gemm", "conv", "dgrad", "fprop",
                               "wgrad")):
        return "cuDNN convolutions"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "GEMM (cuBLAS)"
    if "reduce" in name.lower():
        return "reductions"
    return "elementwise and other"


class Record:
    """Device intervals [(start_us, end_us, name)], host operators [(start_us, end_us,
    name)] and the launch-call count of one profiled stretch."""

    def __init__(self, device: List[Tuple[float, float, str]],
                 host: List[Tuple[float, float, str]], launches: int, units: int):
        self.device = sorted(device)
        self.host = sorted(host)
        self.launches = launches
        self.units = units  # the steps or dispatches profiled

    @property
    def window_s(self) -> float:
        starts = [d[0] for d in self.device] + [h[0] for h in self.host]
        ends = [d[1] for d in self.device] + [h[1] for h in self.host]
        return (max(ends) - min(starts)) / 1e6 if starts else 0.0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def group_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, name in self.device:
            g = kernel_group(name)
            out[g] = out.get(g, 0.0) + (e - s) / 1e6
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The `n` longest gaps between device intervals, each named by the innermost
        host operator open at the gap's start (or "host idle")."""
        busy = self.busy_intervals()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            inner = None
            for hs, he, name in self.host:
                if hs > s:
                    break
                if he >= s and (inner is None or he - hs <= inner[1] - inner[0]):
                    inner = (hs, he, name)
            out.append([inner[2][:120] if inner else "host idle", (e - s) / 1e6])
        return out


def profile(fn: Callable[[], int]) -> Record:
    """Run `fn` (it returns how many steps or dispatches it ran) under torch.profiler and
    synchronize inside; the record of what ran."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        units = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    device, host, launches = [], [], 0
    for evt in prof.events():
        start = evt.time_range.start
        end = evt.time_range.end
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device.append((float(start), float(end), evt.name))
        else:
            host.append((float(start), float(end), evt.name))
            if "LaunchKernel" in evt.name:
                launches += 1
    return Record(device, host, launches, units)
