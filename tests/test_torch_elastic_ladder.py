"""The port's ``@hvd.elastic.run`` recovery loop held against the JAX
package's: one scripted sequence of failures and host updates goes through
both loops with a recording state, and both make the same calls
(restore, sync, on_reset, restore_durable, init, shutdown) in the same
order, trip the storm breaker at the same point and exit with
EXIT_REMOVED the same way. World formation is patched out on both sides
(no process group is formed), and so is the backoff sleep."""

import os
import signal
import time

import pytest

import horovod_tpu.basics as ref_basics
import horovod_tpu.elastic.runner as ref_runner
import horovod_tpu.elastic.state as ref_state
import horovod_tpu.exceptions as ref_exc
import horovod_tpu_torch.basics as port_basics
import horovod_tpu_torch.elastic.runner as port_runner
import horovod_tpu_torch.elastic.state as port_state
import horovod_tpu_torch.exceptions as port_exc

PACKAGES = {
    "ref": (ref_basics, ref_runner, ref_state, ref_exc),
    "port": (port_basics, port_runner, port_state, port_exc),
}


def _recording_state(state_mod, calls):
    class Recording(state_mod.State):
        def __init__(self):
            super().__init__()
            self.value = 0
            self._saved = 0
            self.register_reset_callbacks([lambda: calls.append("on_reset")])
            self.register_durable_restore(
                lambda: calls.append("restore_durable"))

        def commit(self):
            calls.append(f"commit {self.value}")
            self._saved = self.value
            self.check_host_updates()

        def restore(self):
            calls.append(f"restore {self._saved}")
            self.value = self._saved

        def sync(self):
            calls.append("sync")

    return Recording()


def _run(name, script, monkeypatch, max_attempts=None):
    """Run ``script`` (one list of actions per attempt of the training
    function) through one package's loop; the calls it made, and how it
    ended."""
    basics, runner, state_mod, exc = PACKAGES[name]
    calls: list = []
    world = {"up": True}

    def init(*a, **k):
        calls.append("init")
        world["up"] = True

    def shutdown():
        calls.append("shutdown")
        world["up"] = False

    monkeypatch.setattr(basics, "init", init)
    monkeypatch.setattr(basics, "shutdown", shutdown)
    monkeypatch.setattr(basics, "is_initialized", lambda: world["up"])
    monkeypatch.setattr(basics, "size", lambda: 2)
    monkeypatch.setattr(time, "sleep", lambda s: calls.append(f"sleep {s}"))
    if max_attempts is not None:
        monkeypatch.setenv("HOROVOD_RECOVERY_MAX_ATTEMPTS", str(max_attempts))
    else:
        monkeypatch.delenv("HOROVOD_RECOVERY_MAX_ATTEMPTS", raising=False)
    monkeypatch.delenv("HOROVOD_RECOVERY_BACKOFF_MAX", raising=False)
    state = _recording_state(state_mod, calls)
    attempts = iter(script)

    def train(st):
        calls.append("train")
        for action in next(attempts):
            if action == "commit":
                st.value += 1
                st.commit()
            elif action == "internal":
                raise exc.HorovodInternalError("peer died")
            elif action == "updated":
                raise exc.HostsUpdatedInterrupt(skip_sync=False)
            elif action == "updated_skip_sync":
                raise exc.HostsUpdatedInterrupt(skip_sync=True)
            elif action == "removed":
                raise exc.RemovedFromWorldError("dropped")
            elif action == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
        return st.value

    prev = signal.getsignal(signal.SIGTERM)
    try:
        result = ("returned", runner.run(train)(state))
    except exc.RecoveryExhaustedError as e:
        result = ("exhausted", type(e.__cause__).__name__)
    except SystemExit as e:
        result = ("exit", e.code)
    finally:
        signal.signal(signal.SIGTERM, prev)
        runner._drain.clear()
        runner.notification_manager.clear()
    return calls, result


SCRIPTS = {
    "ladder": [
        ["commit", "commit", "internal"],           # restore
        ["internal"],                               # rendezvous
        ["internal"],                               # peer -> durable
        ["internal"],                               # durable
        ["commit", "internal"],                     # progress: restore
        ["commit", "updated_skip_sync"],
        ["updated"],
        ["commit", "commit"],
    ],
    "hosts_updated": [
        ["updated_skip_sync"], ["commit", "updated"], ["updated_skip_sync"],
        ["internal"], ["commit"],
    ],
    "removed": [["commit", "internal"], ["removed"]],
    "sigterm": [["commit", "sigterm", "commit", "commit"]],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_the_ladder_makes_the_reference_calls(script, monkeypatch):
    ref = _run("ref", SCRIPTS[script], monkeypatch)
    port = _run("port", SCRIPTS[script], monkeypatch)
    assert port == ref
    if script == "ladder":
        calls, result = port
        assert result == ("returned", 6)
        # restore, then a re-rendezvous without restore, then the durable
        # rung (the peer rung has nothing armed) twice; a commit resets it.
        assert calls.count("restore_durable") == 2
        assert [c for c in calls if c.startswith("restore ")] == [
            "restore 2", "restore 3"]
    if script in ("removed", "sigterm"):
        assert port[1] == ("exit", 202)


def test_storm_breaker_trips_at_the_reference_point(monkeypatch):
    script = [["internal"]] * 5
    ref = _run("ref", script, monkeypatch, max_attempts=3)
    port = _run("port", script, monkeypatch, max_attempts=3)
    assert port == ref
    assert port[1] == ("exhausted", "HorovodInternalError")
    assert port[0].count("train") == 3
