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


def cnn_forward_stacked(params: Params, images: torch.Tensor
                        ) -> torch.Tensor:
    """A cohort of models at once: every leaf carries a leading client
    axis C, images are (C, B, 28, 28, 1) -> logits (C, B, 10).  The
    convolutions run as one grouped convolution (group = client)."""
    c, b = images.shape[:2]
    x = images.permute(1, 0, 4, 2, 3).reshape(b, -1, *images.shape[2:4])
    for name in ("conv1", "conv2"):
        w = params[name + ".w"]                          # (C, O, I, k, k)
        x = F.conv2d(x, w.reshape(-1, *w.shape[2:]),
                     params[name + ".b"].reshape(-1),
                     padding=w.shape[-1] // 2, groups=c)
        x = F.max_pool2d(F.relu(x), 2)
    h, wd = x.shape[-2:]
    x = x.reshape(b, c, -1, h, wd).permute(1, 0, 3, 4, 2).reshape(c, b, -1)
    x = F.relu(torch.baddbmm(params["fc1.b"][:, None, :], x,
                             params["fc1.w"].transpose(1, 2)))
    return torch.baddbmm(params["fc2.b"][:, None, :], x,
                         params["fc2.w"].transpose(1, 2))


def sample_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample categorical cross-entropy: logsumexp - gold logit."""
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cnn_sample_losses(params: Params, images: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Per-sample loss — Eq. 7's l_i numerator terms (no gradient)."""
    return sample_nll(cnn_forward(params, images), labels)
