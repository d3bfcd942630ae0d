"""ResNet (v1.5) in PyTorch.

Port of ``horovod_tpu/models/resnet.py``: ``Bottleneck``, ``ResNet`` and
the ``ResNet50`` / ``ResNet101`` / ``ResNet152`` stage sizes (:89-91). The
forward takes NHWC images, as the flax model does, and views them as NCHW
with ``permute(0, 3, 1, 2)``: no copy, and the activations run in
``channels_last`` memory, where cuDNN's convolutions want them on the card.
``models.convert.resnet_variables_from_flax`` carries flax's ``params`` and
``batch_stats`` across.

Numerics mirror the flax model, not torch's defaults:

- Parameters are float32; convolutions and BatchNorms compute in
  ``dtype`` (bfloat16 on the card), the head in float32: the spatial mean
  runs in ``dtype``, then the Dense in float32 (:84-85).
- ``padding="SAME"`` is XLA's: a stride-2 3x3 convolution and the stride-2
  3x3 max-pool on an even input pad 0 rows before and 1 after (torch's
  ``padding=1`` would pad 1 on both sides: same size, other values), the
  pool with -inf (:35-38, :74).
- BatchNorm is flax's (``momentum=0.9``, ``epsilon=1e-5``, :60-65): in
  training mode it normalizes with the batch statistics and updates its
  running averages with weight 0.1 on the batch's mean and *biased*
  variance, reduced in float32; torch's ``BatchNorm2d`` would take the
  unbiased variance. ``model.eval()`` normalizes with the running averages
  (``use_running_average=not train``). flax reduces the variance as
  ``E[x^2] - E[x]^2``, torch in one pass by Welford's method: the two agree
  to float32 rounding wherever the variance is not swamped by the mean
  (the tests hold them within 1e-5).
- ``process_set=`` makes every BatchNorm a synchronized one: its training
  statistics span the set's members (``sync_batch_norm._SyncBatchNormFn``,
  one allreduce per layer forward and backward), with flax's conventions
  kept. This is flax's BatchNorm bound to an ``axis_name``
  (``horovod_tpu/sync_batch_norm.py:26 SyncBatchNorm``).
- Fresh parameters follow flax's initializers: ``lecun_normal`` (truncated
  normal, std 1/sqrt(fan_in)) for conv and Dense kernels, zero biases, BN
  scale 1, and 0 for the last BN of each block (:42).

No hand-written kernel runs here: the convolutions go to cuDNN and the
head's product to cuBLAS, as the JAX package leaves them to XLA. The
opt-in ``ops.conv_backward.conv1x1`` is not wired in, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.collective_ops import _resolve_process_set
from ..sync_batch_norm import _SyncBatchNormFn

BN_MOMENTUM = 0.9  # flax's: weight of the running average
BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"`` along one dim: ``(before, after)``, with the
    odd row after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _same(x, kernel, stride, value=0.0):
    """``x`` [N, C, H, W] padded as SAME needs it, and the padding left for
    the op itself: symmetric SAME padding stays with the op (no copy);
    asymmetric padding is applied here with ``value``."""
    (top, bottom), (left, right) = (same_pads(x.shape[d], kernel, stride)
                                    for d in (2, 3))
    if top == bottom and left == right:
        return x, (top, left)
    x = F.pad(x, (left, right, top, bottom), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None) -> None:
    # flax's lecun_normal: a normal truncated at 2 sigma, rescaled to std
    # 1/sqrt(fan_in).
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the channels of an [N, C, H, W] tensor.

    Training: one ``torch.batch_norm`` call normalizes with the batch's
    statistics (differentiably through them; cuDNN's fused kernels on the
    card) and leaves the batch's float32 mean and unbiased variance
    ``n/(n-1) var`` in two scratch buffers; the running averages then move
    0.1 of the way to the mean and the biased variance ``var``, as flax's
    do. Evaluation: the running averages normalize. The output has the
    input's dtype; statistics, scale and bias are float32. Like torch's
    ``BatchNorm2d``, training needs more than one value per channel.

    With a ``process_set``, training normalizes with the statistics of the
    batch of every member of the set: ``E[x^2] - E[x]^2`` over the
    allreduced float32 sums, as flax reduces them (``_SyncBatchNormFn``:
    ATen's sync-BatchNorm kernels on the card, not cuDNN's). Its running
    averages move as above; evaluation is unchanged.
    """

    def __init__(self, channels: int, zero_scale: bool = False,
                 device=None, process_set=None):
        super().__init__()
        self.process_set = process_set
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))
        self.zero_scale = zero_scale
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        if self.process_set is not None:
            return _SyncBatchNormFn.apply(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, 1 - BN_MOMENTUM, BN_EPS,
                _resolve_process_set(self.process_set), False)
        # With momentum 1 the call leaves the batch mean and the unbiased
        # batch variance in these two buffers.
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         BN_EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean,
                                                     alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(
                var, alpha=(1 - BN_MOMENTUM) * (n - 1) / n)
        return y


class Conv(nn.Conv2d):
    """A bias-free convolution with flax's SAME or explicit padding,
    computing in ``dtype`` over float32 weights."""

    def __init__(self, cin, cout, kernel, stride=1, padding="SAME",
                 device=None):
        super().__init__(cin, cout, kernel, stride, bias=False,
                         device=device)
        self.same = padding == "SAME"
        if not self.same:
            self.padding = (padding, padding)

    def forward(self, x):
        pad = self.padding
        if self.same:
            x, pad = _same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, pad)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride, v1.5) -> 1x1 x4, each followed by BatchNorm;
    a projection (1x1 with the stride, and BatchNorm) on the residual
    where the shapes change."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 device=None, process_set=None):
        super().__init__()
        cout = filters * 4
        self.conv1 = Conv(cin, filters, 1, device=device)
        self.bn1 = BatchNorm(filters, device=device, process_set=process_set)
        self.conv2 = Conv(filters, filters, 3, stride, device=device)
        self.bn2 = BatchNorm(filters, device=device, process_set=process_set)
        self.conv3 = Conv(filters, cout, 1, device=device)
        self.bn3 = BatchNorm(cout, zero_scale=True, device=device,
                             process_set=process_set)
        self.proj_conv = self.proj_bn = None
        if cin != cout or stride != 1:
            self.proj_conv = Conv(cin, cout, 1, stride, device=device)
            self.proj_bn = BatchNorm(cout, device=device,
                                     process_set=process_set)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.proj_conv is not None:
            residual = self.proj_bn(self.proj_conv(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5: ``model(x)`` with NHWC images ``x [N, H, W, 3]`` ->
    float32 logits ``[N, num_classes]``. ``model.train()`` /
    ``model.eval()`` play flax's ``train`` argument. ``dtype`` is the
    compute dtype (parameters stay float32); ``device`` places the
    parameters; ``process_set`` synchronizes every BatchNorm's training
    statistics over the set (:class:`BatchNorm`)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 device=None, process_set=None):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3, device=device)
        self.bn_init = BatchNorm(num_filters, device=device,
                                 process_set=process_set)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2**i
                blocks.append(Bottleneck(cin, filters,
                                         2 if i > 0 and j == 0 else 1,
                                         device=device,
                                         process_set=process_set))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        self.reset_parameters()
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers: lecun_normal kernels, zero biases, BN scale
        1 (0 for each block's last BN) and bias 0, running mean 0 and
        variance 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        x = F.relu(self.bn_init(self.conv_init(x)))
        x, pad = _same(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, 2, pad)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.head.weight, self.head.bias)


def ResNet50(**kwargs) -> ResNet:
    return ResNet([3, 4, 6, 3], **kwargs)


def ResNet101(**kwargs) -> ResNet:
    return ResNet([3, 4, 23, 3], **kwargs)


def ResNet152(**kwargs) -> ResNet:
    return ResNet([3, 8, 36, 3], **kwargs)
