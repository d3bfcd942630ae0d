"""Elastic training: ``hvd.elastic.run``, ``TorchState``,
``PeerShardedState``, ``ElasticSampler``.

Port of ``horovod_tpu/elastic/`` and ``horovod_tpu/torch/elastic.py``
(``TorchState`` :30, ``ElasticSampler`` :80; ``PeerShardedState``,
``horovod_tpu/elastic/state.py:540-848``), the reference's
``horovod/torch/elastic/``: the ``@hvd.elastic.run`` retry loop
(``runner.py``) over a state that commits, restores and syncs
(``state.py``). Launch the script with ``hvdrun-torch
--host-discovery-script``::

    state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)

    @hvd.elastic.run
    def train(state):
        while state.epoch < epochs:
            ...
            state.epoch += 1
            state.commit()

    train(state)

A ``sync_mode="sharded"`` or ``"fsdp"`` optimizer takes
``hvd.elastic.PeerShardedState(model=, optimizer=, **extras)`` and a step
from ``hvd.make_train_step``: its commits hold this rank's shards only
(about 1/n of the state) and replicate them to its peers
(``peercheck.py``), and the ladder's ``peer`` rung rebuilds a lost rank's
shards from them.

The training loop feeds ``hvd.elastic.observe_loss(loss)`` a
rank-identical loss when ``HOROVOD_LOSS_SPIKE_SIGMA`` is set: a spike
rewinds to the last commit without a new world, and
``hvd.elastic.consume_skip_ahead()`` then says how many batches to skip
(``integrity.py``).

The package imports no torch until one of its names is used (module
``__getattr__``): the elastic driver runs in the launcher process and
imports ``elastic.policy`` from here.
"""

import importlib

# Names defined outside ``torch_state.py``, and the module of each.
_EXPORTS = {
    "run": ".runner",
    "State": ".state",
    "ObjectState": ".state",
    "ExtrasState": ".state",
    "note_memory": ".state",
    "observe_loss": "..integrity",
    "consume_skip_ahead": "..integrity",
}


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    module = importlib.import_module(_EXPORTS.get(name, ".torch_state"),
                                     __name__)
    try:
        value = getattr(module, name)
    except AttributeError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value
