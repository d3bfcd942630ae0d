"""Elastic end to end on gloo, continued: a host is added and the world
scales up through ``HostsUpdatedInterrupt``; and a survivor blocked in an
allreduce with a dead or a hung gloo peer gets ``HorovodInternalError``,
not a hang (the hung peer's case through the coordinated abort)."""

import json
import os
import subprocess
import sys
import threading

import pytest

from test_torch_elastic_e2e import (REPO_ROOT, WORKER, launcher_argv,
                                    launcher_env, write_discovery)


def test_added_host_scales_the_world_up(tmp_path):
    """One worker trains alone; once it has committed an epoch, the test
    adds 127.0.0.1 to the discovery file. The driver publishes a world of
    two and launches the new worker; the first one takes the interrupt at
    its next commit, re-forms the group, and rank 0's state syncs to the
    newcomer. Both end with the same weights."""
    script, hosts_file = write_discovery(tmp_path, ["localhost"])
    proc = subprocess.Popen(
        launcher_argv(script, 1, 1, 2), env=launcher_env(tmp_path, "scale"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO_ROOT)
    lines: list[str] = []

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if "np=1" in line and not hosts_file.read_text().count("127"):
                hosts_file.write_text("localhost\n127.0.0.1\n")

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()
        reader.join(timeout=10)
    text = "".join(lines)
    assert rc == 0, text
    assert "np=1" in text and "host=127.0.0.1 rank=1" in text, text
    finals = {}
    for line in lines:
        if "finished at epoch" in line:
            host = line.split("host=")[1].split()[0]
            finals[host] = (int(line.split("epoch ")[1].split()[0]),
                            json.loads(line.split("weights=")[1]))
    # The job ends when the first worker returns; the other may be
    # terminated before it prints, so hold every one that finished.
    assert finals, text
    assert len({json.dumps(v) for v in finals.values()}) == 1, finals


@pytest.mark.parametrize("peer", ["dead", "hung"])
def test_blocked_survivor_gets_internal_error(peer, tmp_path, monkeypatch):
    """Two elastic workers of one generation against a rendezvous server
    of the test's own. Rank 1 dies (or stops itself) after one allreduce;
    rank 0 is then in, or enters, a second one. A dead gloo peer fails the
    collective; a hung one does not, and the test posts the coordinated
    abort for the generation, which the survivor's monitor turns into
    HorovodInternalError in its wait."""
    from horovod_tpu_torch.runner.http.kv_server import RendezvousServer
    from horovod_tpu_torch.runner.network import free_port

    monkeypatch.setenv("HOROVOD_SECRET_KEY", "c" * 64)
    server = RendezvousServer(host="127.0.0.1")
    server.start()
    coord = f"127.0.0.1:{free_port()}"
    hosts = [["localhost", 1], ["127.0.0.1", 1]]
    server.publish_epoch("world", {
        f"{h}:0": json.dumps({
            "process_id": r, "num_processes": 2, "local_rank": 0,
            "local_size": 1, "cross_rank": r, "cross_size": 2,
            "coordinator": coord, "hosts": hosts}).encode()
        for r, (h, _) in enumerate(hosts)})
    procs = []
    # Reading a worker's output blocks: past 90 s the workers are killed,
    # which ends every read.
    watchdog = threading.Timer(90, lambda: [p.kill() for p in procs])
    watchdog.start()
    try:
        for h, _ in hosts:
            env = launcher_env(
                tmp_path, "blocked", ELASTIC_TEST_PEER=peer,
                HOROVOD_ELASTIC="1", HOROVOD_HOSTNAME=h,
                HOROVOD_ELASTIC_WORKER=f"{h}:0",
                HOROVOD_WORLD_VERSION="1",
                HOROVOD_RENDEZVOUS_ADDR="127.0.0.1",
                HOROVOD_RENDEZVOUS_PORT=str(server.port),
                HOROVOD_SECRET_KEY="c" * 64, CUDA_VISIBLE_DEVICES="")
            procs.append(subprocess.Popen(
                [sys.executable, WORKER], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=REPO_ROOT))
        survivor = procs[0]
        if peer == "hung":
            seen = []
            for line in procs[1].stdout:
                seen.append(line)
                if "peer ready" in line:
                    break
            for line in survivor.stdout:
                seen.append(line)
                if "entering the allreduce" in line:
                    break
            server.post_abort("the peer on 127.0.0.1 is hung")
            for line in survivor.stdout:
                seen.append(line)
                if "survivor got HorovodInternalError" in line:
                    break
            assert ("survivor got HorovodInternalError: coordinated abort "
                    "(world generation 1)") in seen[-1], seen
            # Then the driver's second move: kill the hung host, whose
            # stalled collective the survivor's gloo group still holds.
            procs[1].kill()
        out, _ = survivor.communicate(timeout=60)
        assert survivor.returncode == 0, out
        if peer == "dead":
            assert "survivor got HorovodInternalError" in out, out
    finally:
        watchdog.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
        server.stop()
