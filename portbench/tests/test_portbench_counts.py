"""``counts.py`` against hand counts: one 3x3x3 conv (forward, data and weight gradients),
its transition form (nearest 2x upscale, then the conv, booked as the polyphase conv with 2
taps an axis), and the double backward of a gradient penalty through the conv."""

from __future__ import annotations

import torch

from portbench import counts
from portbench.reference import ops as rops

N, CIN, COUT, S = 2, 3, 5, 4  # batch, channels in and out, output side


def _meta(*shape, grad=False):
    return torch.zeros(shape, device="meta", requires_grad=grad)


def test_a_1x1_conv_counts_as_its_contraction():
    x, w = _meta(N, CIN, S, S, S, grad=True), _meta(1, 1, 1, CIN, COUT, grad=True)
    with counts.Counter() as c:
        y = rops.conv(x, w)
    assert c.calls == [("dense", 2 * N * S ** 3 * CIN * COUT,
                        N * CIN * S ** 3 + CIN * COUT + N * COUT * S ** 3)]


def test_one_conv_forward_and_gradients():
    x, w = _meta(N, CIN, S, S, S, grad=True), _meta(3, 3, 3, CIN, COUT, grad=True)
    macs = N * COUT * S ** 3 * CIN * 27
    elements = N * CIN * S ** 3 + 27 * CIN * COUT + N * COUT * S ** 3
    with counts.Counter() as c:
        y = rops.conv(x, w)
    assert c.calls == [("conv", 2 * macs, elements)]
    with counts.Counter() as c:
        torch.autograd.grad(y.sum(), [x, w])
    assert sorted(c.calls) == [("conv_dgrad", 2 * macs, elements),
                               ("conv_wgrad", 2 * macs, elements)]


def test_transition_counts_the_polyphase_conv():
    x, w = _meta(N, CIN, S // 2, S // 2, S // 2, grad=True), _meta(3, 3, 3, CIN, COUT, grad=True)
    macs = N * COUT * S ** 3 * CIN * 2 ** 3  # 2 taps an axis per output voxel
    elements = N * CIN * (S // 2) ** 3 + 27 * CIN * COUT + N * COUT * S ** 3
    with counts.Counter() as c:
        y = rops.upconv(x, w)
    assert c.calls == [("transition", 2 * macs, elements)]
    with counts.Counter() as c:
        torch.autograd.grad(y.sum(), [x, w])
    assert sorted(c.calls) == [("transition_dgrad", 2 * macs, elements),
                               ("transition_wgrad", 2 * macs, elements)]
    k133 = _meta(1, 3, 3, CIN, COUT)  # one depth tap: both depth phases are one conv
    with counts.Counter() as c:
        rops.upconv(x, k133)
    assert c.calls[0][1] == 2 * N * COUT * (S // 2) * S * S * CIN * 4
    with counts.Counter() as c:  # 1x1x1: the coarse volume's channel contraction
        rops.upconv(x, _meta(1, 1, 1, CIN, COUT))
    assert [k for k, _, _ in c.calls] == ["dense"]
    assert c.calls[0][1] == 2 * N * COUT * (S // 2) ** 3 * CIN


def test_penalty_double_backward():
    """g = dD/dx of one conv D, penalty sum(g^2), its gradient in w: the forward, the data
    gradient, and the double backward's two conv-shaped calls: the weight term and the
    term for the cotangent of the output gradient (which a layer inside the critic passes
    on to the layer before it), each with the forward's operations."""
    x, w = _meta(N, CIN, S, S, S, grad=True), _meta(3, 3, 3, CIN, COUT, grad=True)
    macs = N * COUT * S ** 3 * CIN * 27
    elements = N * CIN * S ** 3 + 27 * CIN * COUT + N * COUT * S ** 3
    with counts.Counter() as c:
        (g,) = torch.autograd.grad(rops.conv(x, w).sum(), x, create_graph=True)
        torch.autograd.grad((g * g).sum(), w)
    assert c.calls == [("conv", 2 * macs, elements), ("conv_dgrad", 2 * macs, elements),
                       ("conv", 2 * macs, elements), ("conv", 2 * macs, elements)]


def test_step_counts_are_those_of_its_parts():
    """A reference step's count is the sum of its calls, and the stabilizing half (no
    transition branch) counts less than the mixing half."""
    from portbench.reference import train as rt

    cfg = rt.model_cfg(dict(
        architecture="pgan", start_shape="(1, 1, 2, 2)", latent_dim=8, gp_weight=10.0,
        kernel_spec=[[[], [1, 1, 1]], [[1, 3, 3], [1, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
        filter_spec=[[4, 4], [4, 4], [2, 2]]))
    mix = counts.train_step_counter(cfg, 3, 4, fading=True)
    stab = counts.train_step_counter(cfg, 3, 4, fading=False)
    assert mix.totals(2)["flops"] > stab.totals(2)["flops"] > 0
    assert mix.totals(2)["flops"] == sum(f for _, f, _ in mix.calls)
