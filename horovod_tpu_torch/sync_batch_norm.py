"""BatchNorm whose training statistics span the members of a process set.

Port of ``horovod_tpu/torch/sync_batch_norm.py`` (``_SyncBatchNormFn``
:27, ``SyncBatchNorm`` :87). Statistics are computed over the GLOBAL batch
(every member's), not each rank's shard; the difference matters at small
per-rank batches. Forward: one packed allreduce per layer of each rank's
(sum, sum of squares, count), count-weighted, so ranks may hold different
batch sizes. Backward: one packed allreduce of (sum_dy, sum_dy_xhat), so
the input's gradient equals single-process BatchNorm's over the
concatenated batch. Both go through the port's own ``allreduce(op=Sum)``
over the set's group: NCCL on the card, gloo on the CPU (the reference's
``_allreduce_t`` :20 copies through the host; nothing here does).

On the card the local work is ATen's fused sync-BatchNorm kernels, the
ones ``torch.nn.SyncBatchNorm`` runs (``batch_norm_stats``,
``batch_norm_elemt``, ``batch_norm_backward_reduce``,
``batch_norm_backward_elemt``; channels_last aware, float32 statistics
for a bf16 or fp16 input); on the CPU, where ATen has none of them,
explicit float32 sums do the same work. Either way the statistics are
float32 and the output has the input's dtype. The weight's and the bias's
gradients are this rank's own, as the reference's: the
``DistributedOptimizer`` reduces them with the rest.
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from .ops.collective_ops import Sum, _resolve_process_set, allreduce
from .utils import env


def _on_the_wire(process_set) -> bool:
    """A one-member set reduces nothing, unless
    ``HOROVOD_FORCE_WIRE_MACHINERY=1`` asks for the allreduces anyway."""
    return (process_set.size() > 1
            or env.get_str(env.FORCE_WIRE_MACHINERY) == "1")


def _local_sums(x, dims):
    """This rank's per-channel float32 sum and sum of squares of ``x``."""
    if x.is_cuda:
        # One Welford pass. With eps 0 the variance is 1/invstd^2; ATen
        # gives a constant channel's invstd as 0.
        n = x.numel() // x.size(1)
        mean, invstd = torch.batch_norm_stats(x, 0.0)
        var = torch.where(invstd > 0, invstd.reciprocal().square(), 0.0)
        return mean * n, (var + mean * mean) * n
    xf = x.float()
    return xf.sum(dim=dims), (xf * xf).sum(dim=dims)


class _SyncBatchNormFn(torch.autograd.Function):
    """y = (x - mean) * invstd * weight + bias over the set's batch.

    ``momentum`` is the weight of this batch in the running averages (the
    module resolves torch's ``momentum=None``); ``unbiased`` picks the
    running variance torch keeps (``n/(n-1) var``) or flax's (``var``).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, process_set, unbiased=True):
        dims = [0] + list(range(2, x.dim()))
        count = torch.full((1,), x.numel() // x.size(1),
                           dtype=torch.float32, device=x.device)
        total_sum, total_sqsum = _local_sums(x, dims)
        if _on_the_wire(process_set):
            c = x.size(1)
            packed = allreduce(torch.cat([total_sum, total_sqsum, count]),
                               op=Sum, process_set=process_set)
            total_sum, total_sqsum = packed[:c], packed[c:2 * c]
            count = packed[2 * c:]
        mean = total_sum / count
        var = total_sqsum / count - mean * mean
        invstd = torch.rsqrt(var + eps)
        if running_mean is not None:
            with torch.no_grad():
                kept = var * (count / (count - 1).clamp_min(1.0)) \
                    if unbiased else var
                running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
                running_var.mul_(1 - momentum).add_(kept, alpha=momentum)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.process_set = process_set
        if x.is_cuda:
            return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        shape = [1, -1] + [1] * (x.dim() - 2)
        y = ((x.float() - mean.view(shape))
             * (invstd * weight.float()).view(shape)
             + bias.float().view(shape))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c = grad_out.size(1)
        if x.is_cuda:
            # ATen's channels_last kernels want both tensors in x's layout.
            layout = (torch.channels_last if x.dim() == 4
                      and x.is_contiguous(memory_format=torch.channels_last)
                      else torch.contiguous_format)
            dy = grad_out.contiguous(memory_format=layout)
            sum_dy, sum_dy_xmu, grad_weight, grad_bias = (
                torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                 True, True, True))
            if _on_the_wire(ctx.process_set):
                packed = allreduce(torch.cat([sum_dy, sum_dy_xmu]), op=Sum,
                                   process_set=ctx.process_set)
                sum_dy, sum_dy_xmu = packed[:c], packed[c:]
            grad_input = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                count.to(torch.int32))
            return (grad_input, grad_weight, grad_bias, None, None, None,
                    None, None, None)
        dims = [0] + list(range(2, grad_out.dim()))
        shape = [1, -1] + [1] * (grad_out.dim() - 2)
        dy = grad_out.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_dy = dy.sum(dim=dims)
        sum_dy_xhat = (dy * xhat).sum(dim=dims)
        grad_weight, grad_bias = sum_dy_xhat, sum_dy
        if _on_the_wire(ctx.process_set):
            packed = allreduce(torch.cat([sum_dy, sum_dy_xhat]), op=Sum,
                               process_set=ctx.process_set)
            sum_dy, sum_dy_xhat = packed[:c], packed[c:]
        # d/dx of BatchNorm over the set's batch.
        grad_input = (dy - (sum_dy / count).view(shape)
                      - xhat * (sum_dy_xhat / count).view(shape)) * (
            invstd * weight.float()).view(shape)
        return (grad_input.to(x.dtype), grad_weight.to(weight.dtype),
                grad_bias.to(weight.dtype), None, None, None, None, None,
                None)


class SyncBatchNorm(_BatchNorm):
    """Drop-in BatchNorm whose training statistics span the members of
    ``process_set`` (default: the world).

    ``SyncBatchNorm(num_features, eps, momentum, affine,
    track_running_stats, process_set=...)`` takes ``nn.BatchNorm2d``'s
    arguments and conventions: momentum 0.1, or ``None`` for the
    cumulative average; the unbiased running variance. Evaluation
    normalizes with the running statistics and communicates nothing. Every
    member calls it on its own batch in training; the members' batch sizes
    may differ.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float | None = 0.1, affine: bool = True,
                 track_running_stats: bool = True, device=None, dtype=None,
                 process_set=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device, dtype)
        self.process_set = process_set

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input, got {x.dim()}D")

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            return super().forward(x)
        # torch's semantics: momentum=None is the cumulative average, with
        # weight 1/num_batches_tracked.
        if self.track_running_stats:
            self.num_batches_tracked.add_(1)
        if self.momentum is None:
            momentum = (1.0 / float(self.num_batches_tracked.item())
                        if self.track_running_stats else 0.0)
        else:
            momentum = self.momentum
        c = x.size(1)
        weight = self.weight if self.weight is not None else x.new_ones(
            c, dtype=torch.float32)
        bias = self.bias if self.bias is not None else x.new_zeros(
            c, dtype=torch.float32)
        return _SyncBatchNormFn.apply(
            x, weight, bias,
            self.running_mean if self.track_running_stats else None,
            self.running_var if self.track_running_stats else None,
            momentum, self.eps, _resolve_process_set(self.process_set))
