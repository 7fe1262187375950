"""The paper's 7-layer MNIST CNN (conv,pool,conv,pool,flatten,fc,fc).

This is the local model every FL participant trains (paper §6.1,
~1.66M trainable variables).  Public layout is NHWC, as in
``repro.models.cnn``: images are ``(B, 28, 28, 1)``.  Parameters are a
flat ``dict[str, Tensor]`` in PyTorch's layout — conv weights OIHW,
dense weights ``(out, in)`` — and the fc1 rows (its ``in`` axis) follow
the NHWC flatten order, so the forward permutes its NCHW activation to
NHWC before flattening (``convert.py`` carries parameters across).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.mnist_cnn import CNNConfig

Params = Dict[str, torch.Tensor]
PARAM_NAMES = ("conv1.w", "conv1.b", "conv2.w", "conv2.b",
               "fc1.w", "fc1.b", "fc2.w", "fc2.b")


def init_cnn(gen: torch.Generator, cfg: CNNConfig, device=None) -> Params:
    """He-normal weights, zero biases, drawn from ``gen`` on the CPU."""
    k = cfg.kernel_size
    c1, c2 = cfg.conv_channels
    flat = (cfg.image_size // 4) ** 2 * c2        # two 2x2 pools

    def he(shape, fan_in):
        return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)

    p = {"conv1.w": he((c1, cfg.channels, k, k), k * k * cfg.channels),
         "conv1.b": torch.zeros(c1),
         "conv2.w": he((c2, c1, k, k), k * k * c1),
         "conv2.b": torch.zeros(c2),
         "fc1.w": he((cfg.fc_width, flat), flat),
         "fc1.b": torch.zeros(cfg.fc_width),
         "fc2.w": he((cfg.num_classes, cfg.fc_width), cfg.fc_width),
         "fc2.b": torch.zeros(cfg.num_classes)}
    return {n: t.to(device) for n, t in p.items()}


def count_params(params: Params) -> int:
    return sum(int(t.numel()) for t in params.values())


def cnn_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 28, 28, 1) NHWC -> logits (B, 10)."""
    x = images.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        w = params[name + ".w"]
        x = F.conv2d(x, w, params[name + ".b"], padding=w.shape[-1] // 2)
        x = F.max_pool2d(F.relu(x), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    x = F.relu(F.linear(x, params["fc1.w"], params["fc1.b"]))
    return F.linear(x, params["fc2.w"], params["fc2.b"])


def _gemm(a, b, bias=None, rowsum=False):
    """``kernels.ops.cohort_gemm`` (imported here: the kernels' plain
    versions import this module)."""
    from repro_torch.kernels import ops
    return ops.cohort_gemm(a, b, bias, rowsum)


class _StackedConvGemm(torch.autograd.Function):
    """A cohort's same-padded convolution as patches times weights: x (B,
    C*I, H, W) client-major channels, w (C, O, I, k, k), b (C, O) -> (B,
    C*O, H, W).  Every product is one ``cohort_gemm`` over the (sample,
    client) pairs, the weights a broadcast view over the batch: the
    forward (K = I*k*k), the weight gradient (K = H*W, the batch sum its
    R axis) with the bias gradient (its a operand's row sums, in the
    same call) and the input gradient (K = O), then ``fold``'s
    fixed-order sums.  On the
    card each sum's order is set by the product's own sizes, never by
    the cohort's, so a client's outputs and gradients are the same bits
    whether it trains alone, in a cohort bucket or in a rank's slice of
    one (ROADMAP C8, C12; on the CPU the plain version's call per
    client, C14).  The patches are strided views of the padded input
    gathered by one copy (``F.unfold`` on CUDA launches a kernel per
    sample)."""

    @staticmethod
    def forward(ctx, x, w, b):
        bsz, h, wd = x.shape[0], x.shape[2], x.shape[3]
        c, o, i, k = w.shape[:4]
        win = F.pad(x, (k // 2,) * 4).unfold(2, k, 1).unfold(3, k, 1)
        cols = win.reshape(bsz, c, i, h, wd, k, k).permute(
            0, 1, 2, 5, 6, 3, 4).reshape(bsz, c, 1, i * k * k, h * wd)
        wm = w.reshape(c, o, i * k * k)
        out = _gemm(wm[None, :, None].expand(bsz, c, 1, o, i * k * k), cols,
                    b[None, :, :, None].expand(bsz, c, o, h * wd))
        ctx.save_for_backward(cols, wm)
        ctx.shape = (bsz, c, o, i, k, h, wd)
        return out.view(bsz, c * o, h, wd)

    @staticmethod
    def backward(ctx, gy):
        cols, wm = ctx.saved_tensors
        bsz, c, o, i, k, h, wd = ctx.shape
        ikk, hw = i * k * k, h * wd
        g = gy.reshape(bsz, c, o, hw)
        # sum over the batch (R) of g (O, HW) @ cols^T (HW, IKK)
        g_r = g.permute(1, 0, 2, 3)[None]            # (1, C, B, O, HW)
        gw, gb = _gemm(g_r, cols[:, :, 0].permute(1, 0, 3, 2)[None],
                       rowsum=True)
        gw, gb = gw.view(c, o, i, k, k), gb.view(c, o)
        gx = None
        if ctx.needs_input_grad[0]:
            gcols = _gemm(wm.transpose(1, 2)[None, :, None].expand(
                bsz, c, 1, ikk, o), g[:, :, None])
            gx = F.fold(gcols.view(bsz, c * ikk, hw), (h, wd), k,
                        padding=k // 2)
        return gx, gw, gb


def _stacked_conv_gemm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    """``_StackedConvGemm``: the cohort's stacked convolution."""
    return _StackedConvGemm.apply(x, w, b)


class _StackedLinear(torch.autograd.Function):
    """A cohort's dense layer: x (C, B, In), w (C, Out, In), b (C, Out)
    -> x w^T + b (C, B, Out), forward and backward (the input gradient,
    K = Out; the weight gradient, K = B, with the bias gradient, its a
    operand's row sums) each one ``cohort_gemm``, so a client's
    outputs and gradients do not depend on the cohort's size (ROADMAP
    C12, C14)."""

    @staticmethod
    def forward(ctx, x, w, b):
        c, bsz = x.shape[:2]
        out = _gemm(x[None, :, None], w.transpose(1, 2)[None, :, None],
                    b[None, :, None, :].expand(1, c, bsz, w.shape[1]))
        ctx.save_for_backward(x, w)
        return out[0]

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        c, bsz = x.shape[:2]
        g = gy[None, :, None]                        # (1, C, 1, B, Out)
        gx = _gemm(g, w[None, :, None])[0]
        gw, gb = _gemm(gy.transpose(1, 2)[None, :, None], x[None, :, None],
                       rowsum=True)
        return gx, gw[0], gb[0]


def _stacked_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                    ) -> torch.Tensor:
    """``_StackedLinear``: the cohort's dense layer."""
    return _StackedLinear.apply(x, w, b)


def cnn_forward_stacked(params: Params, images: torch.Tensor
                        ) -> torch.Tensor:
    """A cohort of models at once: every leaf carries a leading client
    axis C, images are (C, B, 28, 28, 1) -> logits (C, B, 10).

    Every product, forward and backward, is a ``cohort_gemm``
    (``_stacked_conv_gemm``, ``_stacked_linear``): on the card the
    kernel, whose sums run in an order set by the product's own sizes,
    and on the CPU its plain version, one library call per client.  A
    grouped convolution or one batched GEMM over the cohort picks its
    algorithm by the group or batch count (cuDNN's Winograd at one
    group, ROADMAP C8; cuBLAS, C12; on the CPU the grouped convolution
    and MKL's batched GEMM past one thread, C14), so a client trained
    alone (the loop engine) drifted from the same client in a cohort."""
    c, b = images.shape[:2]
    x = images.permute(1, 0, 4, 2, 3).reshape(b, -1, *images.shape[2:4])
    for name in ("conv1", "conv2"):
        x = _stacked_conv_gemm(x, params[name + ".w"], params[name + ".b"])
        x = F.max_pool2d(F.relu(x), 2)
    h, wd = x.shape[-2:]
    x = x.reshape(b, c, -1, h, wd).permute(1, 0, 3, 4, 2).reshape(c, b, -1)
    x = F.relu(_stacked_linear(x, params["fc1.w"], params["fc1.b"]))
    return _stacked_linear(x, params["fc2.w"], params["fc2.b"])


def sample_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample categorical cross-entropy: logsumexp - gold logit."""
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cnn_sample_losses(params: Params, images: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Per-sample loss — Eq. 7's l_i numerator terms (no gradient)."""
    return sample_nll(cnn_forward(params, images), labels)
