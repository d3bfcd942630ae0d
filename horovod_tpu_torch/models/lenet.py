"""LeNet-5-style convnet for MNIST, in PyTorch.

Port of ``horovod_tpu/models/lenet.py``: ``LeNet`` (two 3x3 SAME convs
with ReLU and 2x2 max-pools, then Dense 128 and Dense ``num_classes``) and
``cross_entropy_loss``, which the JAX package's bench also takes as the
ResNet loss. The forward takes NHWC images, as the flax model does, and
views them as NCHW with ``permute(0, 3, 1, 2)`` (no copy).

flax flattens the NHWC activation, so the first Dense's rows are in (h, w,
c) order: the port permutes its activation back to NHWC before the
flatten, and ``fc1`` holds flax's ``Dense_0`` kernel as it is (transposed,
as every Dense). Fresh parameters follow flax's initializers
(``lecun_normal`` kernels, zero biases).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class LeNet(nn.Module):
    """``model(x)`` with ``x [N, image_size, image_size, 1]`` (NHWC) ->
    logits ``[N, num_classes]``."""

    def __init__(self, num_classes: int = 10, image_size: int = 28,
                 device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, device=device)
        side = image_size // 4
        self.fc1 = nn.Linear(side * side * 64, 128, device=device)
        self.fc2 = nn.Linear(128, num_classes, device=device)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in (self.conv1, self.conv2, self.fc1, self.fc2):
            fan_in = m.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        # flax's flatten order: (h, w, c).
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc2(F.relu(self.fc1(x)))


def cross_entropy_loss(logits, labels, num_classes: int = 10):
    """Mean over the batch of ``-sum(one_hot(labels) * log_softmax)``."""
    one_hot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    return -(one_hot * logp).sum(dim=-1).mean()
