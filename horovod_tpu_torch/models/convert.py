"""Carry weights from the JAX package's flax models to the port.

Each converter takes flax trees as nested dicts of arrays (numpy, or
anything ``np.asarray`` reads) and returns the ``state_dict`` of the
port's module:

- ``bert_params_from_flax(params)``: ``horovod_tpu.models.bert.Bert`` ->
  ``horovod_tpu_torch.models.bert.Bert``;
- ``resnet_variables_from_flax(params, batch_stats)``:
  ``horovod_tpu.models.resnet.ResNet`` -> ``models.resnet.ResNet``, the
  running statistics included;
- ``lenet_params_from_flax(params)``: ``horovod_tpu.models.lenet.LeNet`` ->
  ``models.lenet.LeNet``.

Every flax leaf is consumed exactly once; a missing or left-over leaf
raises. Conv kernels are HWIO ``[kh, kw, in, out]`` in flax and OIHW in
torch (``transpose(3, 2, 0, 1)``); Dense kernels ``[in, out]`` are the
transpose of ``nn.Linear``'s weight. Imports no flax.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


class _Leaves:
    """The leaves of a flax tree by "/"-joined path; ``take`` pops one as a
    float32 array, ``put`` adds a state_dict entry, ``done`` returns the
    state_dict once every leaf was taken."""

    def __init__(self, tree, what: str):
        self.what = what
        self.leaves = {"/".join(path): val for path, val in _flatten(tree)}
        self.sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def take(self, path: str) -> np.ndarray:
        try:
            val = self.leaves.pop(path)
        except KeyError:
            raise KeyError(
                f"flax {self.what} have no leaf {path!r}") from None
        return np.asarray(val, dtype=np.float32)

    def put(self, name: str, arr: np.ndarray) -> None:
        self.sd[name] = torch.tensor(np.ascontiguousarray(arr))

    def conv(self, flax_name: str, torch_name: str) -> None:
        self.put(f"{torch_name}.weight",
                 self.take(f"{flax_name}/kernel").transpose(3, 2, 0, 1))

    def dense(self, flax_name: str, torch_name: str) -> None:
        self.put(f"{torch_name}.weight", self.take(f"{flax_name}/kernel").T)
        self.put(f"{torch_name}.bias", self.take(f"{flax_name}/bias"))

    def done(self) -> "OrderedDict[str, torch.Tensor]":
        if self.leaves:
            raise ValueError(
                f"flax {self.what} not consumed by the conversion: "
                f"{sorted(self.leaves)}")
        return self.sd


def bert_params_from_flax(params) -> "OrderedDict[str, torch.Tensor]":
    tree = _Leaves(params, "BERT params")
    take, put, dense = tree.take, tree.put, tree.dense
    for emb in ("token_embeddings", "position_embeddings", "type_embeddings"):
        put(f"{emb}.weight", take(f"{emb}/embedding"))

    def layer_norm(flax_name: str, torch_name: str) -> None:
        put(f"{torch_name}.weight", take(f"{flax_name}/scale"))
        put(f"{torch_name}.bias", take(f"{flax_name}/bias"))

    layer_norm("ln_emb", "ln_emb")
    num_layers = sum(1 for key in params if str(key).startswith("layer_"))
    for i in range(num_layers):
        f, t = f"layer_{i}", f"layers.{i}"
        for proj in ("query", "key", "value"):
            # DenseGeneral kernel [E, heads, head_dim], bias [heads, head_dim].
            kernel = take(f"{f}/attention/{proj}/kernel")
            E = kernel.shape[0]
            put(f"{t}.attention.{proj}.weight", kernel.reshape(E, -1).T)
            put(f"{t}.attention.{proj}.bias",
                take(f"{f}/attention/{proj}/bias").reshape(-1))
        # Output DenseGeneral over (heads, head_dim): kernel [heads, hd, E].
        kernel = take(f"{f}/attention/out/kernel")
        put(f"{t}.attention.out.weight",
            kernel.reshape(-1, kernel.shape[-1]).T)
        put(f"{t}.attention.out.bias", take(f"{f}/attention/out/bias"))
        layer_norm(f"{f}/ln_attn", f"{t}.ln_attn")
        dense(f"{f}/mlp_in", f"{t}.mlp_in")
        dense(f"{f}/mlp_out", f"{t}.mlp_out")
        layer_norm(f"{f}/ln_mlp", f"{t}.ln_mlp")
    dense("mlm_transform", "mlm_transform")
    layer_norm("mlm_ln", "mlm_ln")
    put("mlm_bias", take("mlm_bias"))
    return tree.done()


def resnet_variables_from_flax(params,
                               batch_stats) -> "OrderedDict[str, torch.Tensor]":
    """flax ``params`` and ``batch_stats`` of a ResNet -> the port's
    ``state_dict``: BN ``scale``/``bias`` to ``weight``/``bias``, ``mean``/
    ``var`` to ``running_mean``/``running_var``."""
    tree = _Leaves({"params": params, "batch_stats": batch_stats},
                   "ResNet variables")

    def bn(flax_name: str, torch_name: str) -> None:
        tree.put(f"{torch_name}.weight",
                 tree.take(f"params/{flax_name}/scale"))
        tree.put(f"{torch_name}.bias", tree.take(f"params/{flax_name}/bias"))
        tree.put(f"{torch_name}.running_mean",
                 tree.take(f"batch_stats/{flax_name}/mean"))
        tree.put(f"{torch_name}.running_var",
                 tree.take(f"batch_stats/{flax_name}/var"))

    tree.conv("params/Conv_0", "conv_init")
    bn("BatchNorm_0", "bn_init")
    blocks = sum(1 for key in params if str(key).startswith("Bottleneck_"))
    for i in range(blocks):
        f, t = f"Bottleneck_{i}", f"blocks.{i}"
        for j in range(3):
            tree.conv(f"params/{f}/Conv_{j}", f"{t}.conv{j + 1}")
            bn(f"{f}/BatchNorm_{j}", f"{t}.bn{j + 1}")
        if "Conv_3" in params[f]:  # the projection of the residual
            tree.conv(f"params/{f}/Conv_3", f"{t}.proj_conv")
            bn(f"{f}/BatchNorm_3", f"{t}.proj_bn")
    tree.dense("params/Dense_0", "head")
    return tree.done()


def lenet_params_from_flax(params) -> "OrderedDict[str, torch.Tensor]":
    """flax ``params`` of LeNet -> the port's ``state_dict``. ``Dense_0``'s
    rows stay in flax's (h, w, c) order, which the port's flatten keeps."""
    tree = _Leaves(params, "LeNet params")
    for i in range(2):
        tree.conv(f"Conv_{i}", f"conv{i + 1}")
        tree.put(f"conv{i + 1}.bias", tree.take(f"Conv_{i}/bias"))
        tree.dense(f"Dense_{i}", f"fc{i + 1}")
    return tree.done()
