"""Functional op library of the port (counterpart of ``saragan_tpu/ops/core.py``).

Plain functions on tensors over explicit parameters (``Scope``).  Activations are NC(D)HW
and conv weights keep the reference's ``(*kernel, in, out)`` layout; they are permuted to
PyTorch's ``(out, in, *kernel)`` only at use.  Ops are rank-generic: the spatial rank
comes from ``x.ndim``.

The conv engine is an explicit argument, never a module global:

* ``direct``: ``F.conv3d`` / ``F.conv2d`` with SAME padding (the reference's serving
  default, a library conv outside any kernel of ours);
* ``flat``: the hand-written CUDA kernels of ``ops/conv3d_flat.py`` for every 3-D kernel
  that is not 1x1x1 (the reference's ``pallas`` engine), through the derivative algebra
  of ``ops/conv3d_grad.py``, so forward, dgrad and wgrad (and the penalty's second-order
  terms) all run on them; for 1x1x1 the mul-sum / channel-GEMM path of the reference's
  ``_conv3d_shifted_gemm``, differentiated by autograd.

bf16: an op rounds where the reference's rounds.  A Python constant that meets an
activation (a leaky-ReLU slope, an epsilon, a blend factor) is first rounded to the
activation's dtype, as ``jnp.asarray(c, x.dtype)`` does there.

Per-layer noise (the style families) comes from a noise source, a callable
``noise(name, shape, dtype, device) -> tensor``: ``LayerNoise`` draws each layer's noise
from a generator seeded by (seed, layer name), as the reference keys it with
``fold_in(rng, _stable_hash(name))``, so a recompute region draws it again bit for bit
and the draw does not depend on call order; ``NoiseByName`` hands in given tensors by
name (the parity tests feed the reference's own noise).
"""

from __future__ import annotations

import functools
import itertools
import math
import zlib
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from saragan_tpu_torch.core import Scope, _name_seed, normal_initializer, zeros_initializer
from saragan_tpu_torch.ops.conv3d_grad import conv3d_c

CONV_ENGINES = ("direct", "flat")


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` (a Python float): multiplying a tensor of that dtype by
    it then rounds once, as the reference's product of two `dtype` operands does."""
    return float(torch.tensor(value, dtype=dtype))


def calculate_gain(activation: str, param=None) -> float:
    """He-init gain of the activations ``act`` applies."""
    if activation == "linear":
        return 1.0
    if activation == "leaky_relu":
        if isinstance(param, bool) or not isinstance(param, (int, float)):
            raise ValueError(f"negative_slope {param} not a valid number")
        return math.sqrt(2.0 / (1 + param**2))
    raise ValueError(f"Unsupported nonlinearity {activation}")


def get_weight(scope: Scope, shape: Sequence[int], activation: str, lrmul: float = 1.0,
               use_eq_lr: bool = True, param=None, name: str = "weight") -> torch.Tensor:
    """Equalized-learning-rate weight: stored N(0, 1/lrmul), scaled at use by
    he_std * lrmul; under a spectral scope then divided by its largest singular value,
    estimated by ``scope.spectral`` power iterations from the persisted start vector
    ``<name>_u`` (a (1, out) parameter; reference ``saragan_tpu/ops/core.py:99-108``)."""
    fan_in = int(np.prod(shape[:-1]))
    he_std = calculate_gain(activation, param) / math.sqrt(fan_in)
    w = scope.get(name, shape, normal_initializer(1.0 / lrmul))
    if use_eq_lr:
        w = w * (he_std * lrmul)
    if scope.spectral:
        u = scope.get(f"{name}_u", (1, shape[-1]), normal_initializer(1.0))
        w, _ = spectral_normalize(w, u, iterations=int(scope.spectral))
    return w


def _l2_normalize(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def _power_iterate(w_mat: torch.Tensor, u: torch.Tensor, iterations: int, eps: float):
    v = None
    for _ in range(iterations):
        v = _l2_normalize(u @ w_mat.T, eps)
        u = _l2_normalize(v @ w_mat, eps)
    return u, v


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, iterations: int = 1,
                       eps: float = 1e-12):
    """(w / sigma, u_new): sigma, the largest singular value of w as a (-1, out) matrix,
    by `iterations` power iterations from `u` (reference ``spectral_normalize``,
    ``saragan_tpu/ops/core.py:589-610``).  No gradient flows through u and v."""
    w_mat = w.reshape(-1, w.shape[-1])
    u_hat, v_hat = _power_iterate(w_mat, u, iterations, eps)
    u_hat, v_hat = u_hat.detach(), v_hat.detach()
    sigma = (v_hat @ w_mat) @ u_hat.T
    return (w_mat / sigma).reshape(w.shape), u_hat


@torch.no_grad()
def refresh_spectral_u(params, iterations: int = 1, eps: float = 1e-12) -> dict:
    """Every persisted ``*_u`` vector power-iterated against its current (raw stored)
    weight: the step's refresh after the update (reference ``refresh_spectral_u``,
    ``saragan_tpu/ops/core.py:613-638``).  Scaling w by the equalized-LR coefficient
    does not change its singular vectors, so iterating on the stored weight is exact."""
    out = dict(params)
    for k, u in params.items():
        if k.endswith("_u") and k[:-2] in params:
            w = params[k[:-2]]
            out[k], _ = _power_iterate(w.reshape(-1, w.shape[-1]), u, iterations, eps)
    return out


def apply_bias(scope: Scope, x: torch.Tensor, lrmul: float = 1.0) -> torch.Tensor:
    """Channel bias on axis 1."""
    b = (scope.get("bias", (x.shape[1],), zeros_initializer()) * lrmul).to(x.dtype)
    if x.ndim == 2:
        return x + b
    return x + b.reshape((1, -1) + (1,) * (x.ndim - 2))


def dense(scope: Scope, x: torch.Tensor, fmaps: int, activation: str, lrmul: float = 1.0,
          param=None) -> torch.Tensor:
    """Fully connected layer without bias."""
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    w = get_weight(scope, (x.shape[1], fmaps), activation, lrmul=lrmul, param=param)
    return torch.matmul(x, w.to(x.dtype))


def _torch_weight(w: torch.Tensor) -> torch.Tensor:
    """(*kernel, in, out) -> (out, in, *kernel)."""
    r = w.ndim - 2
    return w.permute(r + 1, r, *range(r))


def _conv_direct(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    conv = {2: F.conv2d, 3: F.conv3d}[x.ndim - 2]
    return conv(x, _torch_weight(w).to(x.dtype), padding="same")


def _conv3d_1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1x1 conv of the flat engine (reference ``_conv3d_shifted_gemm``): skinny
    channel counts as a broadcast multiply plus an f32 channel sum, else a channel GEMM
    accumulated in f32."""
    n, c, d, h, wd = x.shape
    f = w.shape[-1]
    t = d * h * wd
    w2 = w.reshape(c, f).to(x.dtype)
    if c <= 32 and f <= 32:
        if c == 1:
            y = x.reshape(n, 1, t) * w2.reshape(1, f, 1)
            return y.reshape(n, f, d, h, wd)
        y = torch.sum(x.reshape(n, c, 1, t) * w2.reshape(1, c, f, 1), dim=1,
                      dtype=torch.float32)
        return y.to(x.dtype).reshape(n, f, d, h, wd)
    y = torch.einsum("nct,cf->nft", x.reshape(n, c, t).float(), w2.float())
    return y.to(x.dtype).reshape(n, f, d, h, wd)


def conv_apply(x: torch.Tensor, w: torch.Tensor, engine: str = "direct") -> torch.Tensor:
    """SAME stride-1 conv on explicit (*kernel, in, out) weights."""
    if engine not in CONV_ENGINES:
        raise ValueError(f"conv engine {engine!r} not in {CONV_ENGINES}")
    if engine == "flat" and x.ndim == 5:
        if w.shape[0] * w.shape[1] * w.shape[2] == 1:
            return _conv3d_1x1(x, w)
        return conv3d_c(x, w.to(x.dtype))
    return _conv_direct(x, w)


def conv(scope: Scope, x: torch.Tensor, fmaps: int, kernel: Sequence[int], activation: str,
         param=None, lrmul: float = 1.0, engine: str = "direct") -> torch.Tensor:
    """SAME conv over NC(D)HW with (*kernel, in, out) weights."""
    kernel = tuple(int(k) for k in kernel)
    if len(kernel) != x.ndim - 2:
        raise ValueError(f"kernel {kernel} does not match input {tuple(x.shape)}")
    w = get_weight(scope, (*kernel, x.shape[1], fmaps), activation, param=param, lrmul=lrmul)
    return conv_apply(x, w.to(x.dtype), engine)


def group_conv(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """Grouped SAME stride-1 conv; w: (*kernel, in_per_group, out_total), output channel
    o in group o // (out_total / groups), as the reference's ``feature_group_count``
    (``saragan_tpu/ops/core.py:566-580``).  No family calls it."""
    conv = {2: F.conv2d, 3: F.conv3d}[x.ndim - 2]
    return conv(x, _torch_weight(w).to(x.dtype), padding="same", groups=groups)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One filter per input channel, w: (*kernel, 1, C) (reference ``core.py:583-586``)."""
    return group_conv(x, w, groups=x.shape[1])


def leaky_relu(x: torch.Tensor, alpha_lr: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * in_dtype(alpha_lr, x.dtype))


def act(x: torch.Tensor, activation: str, param=None) -> torch.Tensor:
    if activation == "leaky_relu":
        if param is None:
            raise ValueError("leaky_relu needs its negative slope")
        return leaky_relu(x, alpha_lr=param)
    if activation == "linear":
        return x
    raise ValueError(f"Unknown activation {activation}")


def avg_unpool(x: torch.Tensor, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Nearest-neighbour upsampling of all spatial axes."""
    if gain != 1:
        x = x * gain
    if factor == 1:
        return x
    for axis in range(2, x.ndim):
        x = torch.repeat_interleave(x, factor, dim=axis)
    return x


def upscale(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return avg_unpool(x, factor)


def _phase_taps(k: int):
    """For one axis of conv(repeat(x), w) with odd kernel size k: per output phase p
    (fine index 2q + p), the first coarse offset j0 and, per phase tap i, the kernel
    taps that read the same coarse voxel x[q + j0 + i]."""
    h = k // 2
    taps = []
    for p in (0, 1):
        j0 = (p - h) // 2
        groups = [[] for _ in range((p + k - 1 - h) // 2 - j0 + 1)]
        for dz in range(k):
            groups[(p + dz - h) // 2 - j0].append(dz)
        taps.append((j0, groups))
    return taps


def _sum_taps(w: torch.Tensor, axis: int, groups) -> torch.Tensor:
    """Phase kernel along `axis`: tap i is the sum of w's taps in groups[i].  Slices and
    adds on w's device, so preparing the kernels never waits for the device."""
    out = []
    for g in groups:
        t = w.select(axis, g[0])
        for dz in g[1:]:
            t = t + w.select(axis, dz)
        out.append(t)
    return torch.stack(out, dim=axis)


def upscale_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv(repeat(x), w) for nearest 2x upscaling and a SAME conv with odd kernel w,
    without materializing the upscaled activation (the reference's exact fusion).

    Polyphase form: output phase (p_1..p_r) of the fine grid is a stride-1 valid conv
    of the coarse x with that phase's kernel, whose taps are sums of w's taps that read
    the same coarse voxel (2 per dim for k=3, 1 for k=1).  So 2^r library convs do the
    minimal multiply-adds, through cuDNN's deterministic forward algorithms.  The
    equivalent stride-2 transposed conv runs cuDNN's deterministic dgrad, which is an
    order of magnitude slower at the phase-6 serving shapes on an H100
    (``tools/profile_serving.py`` compares the two)."""
    r = x.ndim - 2
    conv = {2: F.conv2d, 3: F.conv3d}[r]
    spatial = x.shape[2:]
    taps = [_phase_taps(int(k)) for k in w.shape[:r]]
    # one symmetric padding serves both phases of an axis: each phase's output is a
    # window of the padded conv's, so the input is never sliced (or copied)
    pad = [max(max(-j0, j0 + len(g) - 1) for j0, g in t) for t in taps]
    # along an axis of kernel size 1 both phases have the same taps: one conv for both
    groups = [[(0, 1)] if k == 1 else [(0,), (1,)] for k in w.shape[:r]]
    out = x.new_empty((x.shape[0], w.shape[-1], *(2 * s for s in spatial)))
    for combo in itertools.product(*groups):
        wk = w
        for a, ps in enumerate(combo):
            wk = _sum_taps(wk, a, taps[a][ps[0]][1])
        y = conv(x, _torch_weight(wk).to(x.dtype), padding=tuple(pad))
        for phases in itertools.product(*combo):
            src = [slice(taps[a][p][0] + pad[a], taps[a][p][0] + pad[a] + spatial[a])
                   for a, p in enumerate(phases)]
            dest = [slice(p, None, 2) for p in phases]
            out[(slice(None), slice(None), *dest)] = y[(slice(None), slice(None), *src)]
    return out


def _box_sum(w: torch.Tensor, axis: int) -> torch.Tensor:
    """w'[j] = w[j - 1] + w[j] along `axis` (length k + 1, zero outside)."""
    z = torch.zeros_like(w.narrow(axis, 0, 1))
    return torch.cat([z, w], dim=axis) + torch.cat([w, z], dim=axis)


def conv_downscale(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """downscale(conv(x, w)) for a SAME conv with odd kernel w, as one stride-2 conv with
    the box-averaged (k + 1)^r kernel (reference ``saragan_tpu/ops/core.py:775-815``).
    Exact only where no nonlinearity sits between the conv and the pool, so no family
    calls it, as in the reference."""
    r = x.ndim - 2
    wp = w
    for axis in range(r):
        wp = _box_sum(wp, axis)
    wp = wp * 0.5 ** r
    conv = {2: F.conv2d, 3: F.conv3d}[r]
    pads = [(int(k) - 1) // 2 for k in w.shape[:r]]
    return conv(x, _torch_weight(wp).to(x.dtype), stride=2, padding=pads)


def avg_pool(x: torch.Tensor, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Average pooling of all spatial axes (stride = window = factor), as reshape + mean;
    the mean accumulates in f32 and rounds once to x.dtype, as the reference's jnp.mean
    does for bf16."""
    if gain != 1:
        x = x * gain
    if factor == 1:
        return x
    spatial = x.shape[2:]
    if any(s % factor for s in spatial):
        raise ValueError(f"avg_pool factor {factor} does not divide {tuple(x.shape)}")
    split = [v for s in spatial for v in (s // factor, factor)]
    axes = tuple(3 + 2 * i for i in range(len(spatial)))
    y = x.reshape(*x.shape[:2], *split)
    if x.dtype == torch.float64:
        return y.mean(dim=axes)
    return y.mean(dim=axes, dtype=torch.float32).to(x.dtype)


def downscale(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return avg_pool(x, factor)


def pixel_norm(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Per-voxel channel normalization, rounded where the reference rounds
    (``saragan_tpu/ops/core.py:842-844``): x² in x.dtype, the channel mean accumulated in
    f32 and returned in x.dtype, epsilon added in x.dtype, the rsqrt taken in x.dtype."""
    sq = torch.square(x)
    m = sq.mean(dim=1, keepdim=True) if x.dtype == torch.float64 else \
        sq.mean(dim=1, keepdim=True, dtype=torch.float32).to(x.dtype)
    return x * torch.rsqrt(m + in_dtype(epsilon, x.dtype))


def mean_keepdim(t: torch.Tensor, dims) -> torch.Tensor:
    """Mean over `dims` (kept), accumulated in f32 and returned in t's dtype, as the
    reference's jnp.mean does for bf16 (f64 stays f64)."""
    if t.dtype == torch.float64:
        return t.mean(dim=dims, keepdim=True)
    return t.mean(dim=dims, keepdim=True, dtype=torch.float32).to(t.dtype)


def instance_norm(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Per-sample, per-channel normalization over the spatial axes, in x's dtype (the
    means accumulated in f32), as the reference rounds it (``saragan_tpu/ops/core.py:
    869-876``)."""
    if x.ndim < 4:
        raise ValueError(f"instance_norm needs a spatial input; got {tuple(x.shape)}")
    dims = tuple(range(2, x.ndim))
    x = x - mean_keepdim(x, dims)
    return x * torch.rsqrt(mean_keepdim(torch.square(x), dims)
                           + in_dtype(epsilon, x.dtype))


def minibatch_stddev_layer(x: torch.Tensor, group_size: int = 4, passes: int = 1,
                           mesh=None) -> torch.Tensor:
    """Append the per-group stddev statistic as one more channel (reference
    ``saragan_tpu/ops/core.py:847-866``), statistics in f32 whatever x's dtype.

    The reference's groups are strided across the batch: it reshapes to (G, N/G, ...),
    so sample n is in the group of n mod N/G.  `passes` > 1 says that x holds that many
    batches stacked along axis 0 (the stacked critic pass, [fake, real]) and forms the
    groups inside each, as the reference's ``jax.vmap`` over the stacked passes does.

    With a data-parallel `mesh` x holds this rank's rows of each pass, and the groups run
    over each pass's global batch, as the reference's over its sharded global array: each
    pass is gathered from every rank (``parallel.gather_rows``, differentiable to any
    order), the statistic formed over it, and this rank's rows kept."""
    if mesh is None or mesh.world_size == 1:
        return _minibatch_stddev(x, group_size, passes)
    from saragan_tpu_torch.parallel.mesh import gather_rows

    n = x.shape[0] // passes
    if n * passes != x.shape[0]:
        raise ValueError(f"batch {x.shape[0]} is not {passes} passes of one size")
    glob = torch.cat([gather_rows(part, mesh) for part in x.split(n)])
    out = _minibatch_stddev(glob, group_size, passes)
    total = n * mesh.world_size
    lo = mesh.rank * n
    return torch.cat([out[p * total + lo:p * total + lo + n] for p in range(passes)])


def _minibatch_stddev(x: torch.Tensor, group_size: int, passes: int) -> torch.Tensor:
    n = x.shape[0] // passes
    if n * passes != x.shape[0]:
        raise ValueError(f"batch {x.shape[0]} is not {passes} passes of one size")
    g = min(group_size, n)
    if n % g:
        raise ValueError(f"minibatch stddev: group {g} does not divide the batch {n}")
    s = tuple(x.shape)
    y = x.reshape(passes, g, n // g, *s[1:]).float()
    y = y - y.mean(dim=1, keepdim=True)
    y = torch.sqrt(torch.square(y).mean(dim=1) + 1e-8)  # (passes, n / g, C, *S)
    y = y.mean(dim=tuple(range(2, y.ndim)), keepdim=True).to(x.dtype)
    y = y.unsqueeze(1).expand(passes, g, n // g, 1, *s[2:]).reshape(x.shape[0], 1, *s[2:])
    return torch.cat([x, y], dim=1)


def _layer_normal(seed: int, name: str, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(_name_seed(seed, name))
    return torch.randn(tuple(shape), generator=gen, device=device)


class LayerNoise:
    """Noise source: each layer's N(0, 1) noise from a generator seeded by (seed, layer
    name), drawn in f32 and cast.  `seeds` is one seed for the whole batch or one per
    sample (row j from ``seeds[j]``, as a (1, ...) draw): a sample's noise is then the
    same served alone or in a batch.  On the meta device it gives shapes only."""

    def __init__(self, seeds: Union[int, Sequence[int]]):
        self.seeds = (int(seeds),) if isinstance(seeds, int) else tuple(int(s) for s in seeds)

    def __call__(self, name: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
        device = torch.device(device)
        if device.type == "meta":
            return torch.empty(tuple(shape), dtype=dtype, device=device)
        if len(self.seeds) == 1:
            return _layer_normal(self.seeds[0], name, shape, device).to(dtype)
        if len(self.seeds) != shape[0]:
            raise ValueError(f"{len(self.seeds)} noise seeds for a batch of {shape[0]}")
        return torch.cat([_layer_normal(s, name, (1, *shape[1:]), device)
                          for s in self.seeds]).to(dtype)

    def chunk(self, num: int) -> list:
        """One source per micro-batch: the rows' seeds split, or one seed derived per
        part."""
        if len(self.seeds) == 1:
            return [LayerNoise(_name_seed(self.seeds[0], f"part/{k}")) for k in range(num)]
        m = len(self.seeds) // num
        return [LayerNoise(self.seeds[k * m:(k + 1) * m]) for k in range(num)]


class RankRowsNoise:
    """This rank's rows of another noise source's global batch: the data-parallel
    counterpart of one key's noise partitioned by XLA.  A layer asking for (n, ...) gets
    rows [rank n, (rank + 1) n) of `source`'s (world_size n, ...) draw."""

    def __init__(self, source, rank: int, world_size: int):
        self.source = source
        self.rank = rank
        self.world_size = world_size

    def __call__(self, name: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
        n = shape[0]
        full = self.source(name, (n * self.world_size, *shape[1:]), dtype, device)
        return full[self.rank * n:(self.rank + 1) * n]


class NoiseByName:
    """Noise source of given tensors, {layer name: (N, 1, *spatial)}."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        self.tensors = dict(tensors)

    def __call__(self, name: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
        t = self.tensors[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"noise {name!r} has shape {tuple(t.shape)}, the layer "
                             f"needs {tuple(shape)}")
        return t.to(device=device, dtype=dtype)

    def chunk(self, num: int) -> list:
        parts = {k: v.chunk(num) for k, v in self.tensors.items()}
        return [NoiseByName({k: p[i] for k, p in parts.items()}) for i in range(num)]


def generator_seed(generator: Optional[torch.Generator]) -> int:
    """A seed for the noise of one draw: a hash of `generator`'s current state (read on
    the host, no device sync), so draws from one generator at different points differ.
    None gives 0."""
    if generator is None:
        return 0
    return zlib.crc32(generator.get_state().numpy().tobytes())


def apply_noise(scope: Scope, x: torch.Tensor, noise, name: str) -> torch.Tensor:
    """Learned-strength per-voxel noise (reference ``saragan_tpu/ops/core.py:879-884``):
    x + n * strength with n of shape (N, 1, *spatial) from the noise source `noise`
    under the layer name `name`."""
    strength = scope.get("noise_strength", (), zeros_initializer()).to(x.dtype)
    n = noise(name, (x.shape[0], 1, *x.shape[2:]), x.dtype, x.device)
    return x + n * strength


def style_mod(scope: Scope, x: torch.Tensor, dlatent: torch.Tensor, activation: str,
              param=None) -> torch.Tensor:
    """AdaIN-style modulation (reference ``saragan_tpu/ops/core.py:887-892``)."""
    s = scope.sub("style_mod")
    style = apply_bias(s, dense(s, dlatent, x.shape[1] * 2, activation, param=param))
    style = style.reshape((-1, 2, x.shape[1]) + (1,) * (x.ndim - 2))
    return x * (style[:, 0] + 1) + style[:, 1]


def to_rgb(scope: Scope, x: torch.Tensor, channels: int = 1,
           engine: str = "direct") -> torch.Tensor:
    """1x1(x1) linear projection to image channels."""
    kernel = (1,) * (x.ndim - 2)
    return apply_bias(scope, conv(scope, x, channels, kernel, activation="linear",
                                  engine=engine))


def from_rgb(scope: Scope, x: torch.Tensor, filters_out: int, activation: str, param=None,
             engine: str = "direct") -> torch.Tensor:
    """1x1(x1) lift from image channels, then bias and activation."""
    kernel = (1,) * (x.ndim - 2)
    x = conv(scope, x, filters_out, kernel, activation, param, engine=engine)
    x = apply_bias(scope, x)
    return act(x, activation, param=param)


def get_kernel(x_shape: Sequence[int], desired_k_shape: Sequence[int]) -> list:
    """Shrink a desired kernel to the largest odd kernel fitting x."""
    if len(x_shape) != len(desired_k_shape):
        raise ValueError(f"shape {x_shape} and kernel {desired_k_shape} differ in rank")
    kernel = []
    for x_i, k_i in zip(x_shape, desired_k_shape):
        if x_i < k_i:
            kernel.append(x_i - 1 if x_i % 2 == 0 else x_i)
        else:
            kernel.append(k_i)
    return kernel


_FILTER_LISTS_3D = {
    "xxs": [256, 256, 64, 32, 16, 8, 4, 2],
    "xs": [256, 256, 64, 64, 32, 16, 8, 4],
    "s": [512, 512, 128, 128, 64, 32, 16, 8],
    "m": [1024, 1024, 256, 256, 128, 64, 32, 16],
    "l": [2048, 2048, 512, 512, 256, 128, 64, 32],
    "xl": [4096, 4096, 1024, 1024, 512, 256, 128, 64],
    "xxl": [8192, 8192, 2048, 1024, 1024, 512, 256, 128],
}


def num_filters(phase: int, num_phases: int, base_shape: Sequence[int],
                base_dim: Optional[int] = None, size: Optional[str] = None) -> int:
    """Voxel-count-based filter sizing: the phase's voxel count snapped to the nearest
    reference point of the 8-entry tables."""
    if size not in _FILTER_LISTS_3D:
        raise ValueError(f"Unknown size: {size}")
    filter_list = _FILTER_LISTS_3D[size]
    current_dim = [2 ** (phase - 1) * dim for dim in base_shape[1:]]
    log_product = np.log2(np.prod(current_dim))
    reference_log = np.array([4 + n * 3 for n in range(7)])
    return filter_list[int(np.argmin(np.abs(reference_log - log_product)))]


_FILTER_LISTS_2D = {
    "xxs": [64, 64, 64, 64, 64, 64, 64, 64, 32, 16, 8, 4, 2],
    "xs": [128, 128, 128, 128, 128, 128, 128, 128, 64, 32, 16, 8, 4],
    "s": [256, 256, 256, 256, 256, 256, 256, 256, 128, 64, 32, 16, 8],
    "m": [512, 512, 512, 512, 512, 512, 512, 512, 256, 128, 64, 32, 16],
    "l": [512, 512, 512, 512, 512, 512, 512, 512, 512, 256, 128, 64, 32],
    "xl": [1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 512, 256, 128, 64],
    "xxl": [2048, 2048, 2048, 2048, 2048, 2048, 2048, 2048, 2048, 1024, 512, 256, 128],
}


def num_filters_2d(phase: int, num_phases: int, base_dim=None,
                   size: Optional[str] = None) -> int:
    """2D filter sizing."""
    if size not in _FILTER_LISTS_2D:
        raise ValueError(f"Unknown size: {size}")
    return _FILTER_LISTS_2D[size][-num_phases:][phase - 1]
