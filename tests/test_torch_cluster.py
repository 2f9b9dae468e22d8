"""The port's cluster dispatch against the reference's: the shared JSONL
protocol and build-key scheduling fed the same inputs through both
packages, the port's TCP coordinator against scripted workers
(registration, work stealing, disconnects, stray clients, a worker that
leaves after a CUDA error), and ``run_matrix(..., cluster="local:2")`` on
the CPU against the port's serial path and the reference's serial serve
digests."""
import socket
import threading
import time

import pytest
import torch

from repro.runner import BenchmarkRunner as RefBenchmarkRunner
from repro.runner import ScenarioMatrix as RefScenarioMatrix
from repro.runner import pool as ref_pool
from repro.runner import protocol as ref_protocol
from repro.runner.cluster import scheduler as ref_cluster_scheduler
from repro.runner.scenario import Scenario as RefScenario
from repro_torch.runner import (BenchmarkRunner, Coordinator, ResultStore,
                                RunResult, Scenario, ScenarioMatrix)
from repro_torch.runner import pool, protocol
from repro_torch.runner.cluster import scheduler as cluster_scheduler
from repro_torch.runner.protocol import Channel

# the same functions in both packages, fed the same inputs
PACKAGES = {
    "reference": dict(pool=ref_pool, protocol=ref_protocol,
                      cluster=ref_cluster_scheduler, Scenario=RefScenario),
    "port": dict(pool=pool, protocol=protocol, cluster=cluster_scheduler,
                 Scenario=Scenario),
}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread here and in every worker subprocess (they
    inherit the environment): tiny shapes, and the suite runs in parallel."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)


# ---- protocol ---------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_line_buffer_reassembles_partial_lines(pkg):
    proto = PACKAGES[pkg]["protocol"]
    buf = proto.LineBuffer()
    payload = proto.encode({"op": "a"}) + proto.encode({"op": "b"})
    assert buf.feed(payload[:5]) == []
    assert buf.feed(payload[5:]) == [{"op": "a"}, {"op": "b"}]
    assert buf.feed(b"") == []
    with pytest.raises(ValueError):
        buf.feed(b"[1, 2]\n")          # a line that is not an object


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_channel_roundtrip_over_socketpair(pkg):
    proto = PACKAGES[pkg]["protocol"]
    a, b = socket.socketpair()
    ca, cb = proto.Channel.over_socket(a), proto.Channel.over_socket(b)
    ca.send({"op": "run", "cell": 3})
    assert cb.recv(5.0) == {"op": "run", "cell": 3}
    assert cb.recv(0.05) is None and not cb.eof     # timeout, still open
    a.close()
    assert cb.recv(5.0) is None and cb.eof          # peer closed
    cb.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_job_message_carries_hook_params_and_cell_id(pkg):
    proto, scenario = PACKAGES[pkg]["protocol"], PACKAGES[pkg]["Scenario"]
    sc = scenario(arch="gemma-2b", task="train", batch=1, seq=8)

    class Hook:
        slowdown_s, leak_bytes = 0.5, 128

    msg = proto.job_message(sc, runs=2, warmup=0, profile=True, hook=Hook(), cell=7)
    assert msg["op"] == "run" and msg["cell"] == 7 and msg["profile"]
    assert msg["hook"] == {"slowdown_s": 0.5, "leak_bytes": 128}
    assert scenario.from_dict(msg["scenario"]) == sc
    assert "hook" not in proto.job_message(sc, runs=None, warmup=None, profile=False)
    # the two packages put the same job on the wire
    other = PACKAGES["reference" if pkg == "port" else "port"]
    twin = other["Scenario"](arch="gemma-2b", task="train", batch=1, seq=8)
    assert other["protocol"].job_message(twin, runs=2, warmup=0, profile=True,
                                         hook=Hook(), cell=7) == msg


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_stats_delta_is_monotonic_difference(pkg):
    stats_delta = PACKAGES[pkg]["protocol"].stats_delta
    seen = {}
    assert stats_delta({"model_builds": 2}, seen) == {"model_builds": 2}
    assert stats_delta({"model_builds": 3, "errors": 1}, seen) == \
        {"model_builds": 1, "errors": 1}
    # a respawned worker's counters restart below the snapshot: clamped
    assert stats_delta({"model_builds": 1}, seen) == {"model_builds": 0}
    assert stats_delta(None, seen) == {}


# ---- scheduling: groups, static LPT, steal plan -----------------------------

def _grid(scenario):
    return [scenario(arch=a, task=t, batch=1, seq=8, dtype=d)
            for a in ("a1", "a2") for d in ("fp32", "bf16")
            for t in ("train", "infer_decode")]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_rank_groups_and_steal_plan(pkg):
    p = PACKAGES[pkg]
    scs = _grid(p["Scenario"])
    ranked = p["pool"].rank_groups(scs)
    assert [idxs for idxs, _ in ranked] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert all(w == 5 for _, w in ranked)    # train(4) + infer_decode(1)
    assert p["pool"].assign_shards(scs, 2) == [[0, 1, 4, 5], [2, 3, 6, 7]]
    seeds, queue = p["pool"].steal_plan(ranked, 2)
    assert seeds == [[0, 1], [2, 3]] and list(queue) == [[4, 5], [6, 7]]
    seeds, queue = p["pool"].steal_plan(ranked[:1], 3)
    assert seeds == [[0, 1], [], []] and not queue


@pytest.mark.parametrize("jobs", [1, 2, 3, 5])
def test_scheduling_agrees_with_the_reference_on_a_skewed_matrix(jobs):
    """Mixed tasks, archs, dtypes and modes, groups of unequal weight: the
    two packages group, rank, place and seed them identically."""
    axes = [dict(arch=a, task=t, batch=b, seq=8, dtype=d, mode=m)
            for a in ("gemma-2b", "mamba2-2.7b", "a3")
            for t, m in (("train", "jit_donated"), ("infer_prefill", "jit"),
                         ("infer_decode", "jit_donated"))
            for d in ("fp32", "bf16") for b in (1, 2)
            if not (a == "a3" and t == "train")]
    axes += [dict(arch="gemma-2b", task="serve", batch=4, seq=8, slots=s)
             for s in (2, 3)]
    ref = [RefScenario(**kw) for kw in axes]
    port = [Scenario(**kw) for kw in axes]
    assert pool.rank_groups(port) == ref_pool.rank_groups(ref)
    assert pool.assign_shards(port, jobs) == ref_pool.assign_shards(ref, jobs)
    seeds, queue = pool.steal_plan(pool.rank_groups(port), jobs)
    ref_seeds, ref_queue = ref_pool.steal_plan(ref_pool.rank_groups(ref), jobs)
    assert (seeds, list(queue)) == (ref_seeds, list(ref_queue))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_parse_cluster_spec(pkg):
    parse = PACKAGES[pkg]["cluster"].parse_cluster_spec
    assert parse("local:2") == ("local", "2")
    assert parse("0.0.0.0:5055") == ("bind", "0.0.0.0:5055")
    for bad in ("", "local:0", "local:x", "justahost", "host:"):
        with pytest.raises(ValueError):
            parse(bad)


# ---- the port's coordinator against scripted workers ------------------------

def _fake_result(job: dict) -> RunResult:
    sc = Scenario.from_dict(job["scenario"])
    return RunResult(name=sc.name, bench=sc.bench, arch=sc.arch, task=sc.task,
                     batch=sc.batch, seq=sc.seq, dtype=sc.dtype, mode=sc.mode,
                     status="ok", median_us=1.0, runs=1)


def _connect_worker(address: str, host: str) -> Channel:
    h, _, p = address.rpartition(":")
    chan = Channel.over_socket(socket.create_connection((h, int(p)), timeout=5))
    chan.send({"op": "register", "host": host, "capacity": 1})
    return chan


def _run_in_thread(coord, scs, out):
    t = threading.Thread(target=lambda: out.update(
        zip(("results", "stats"), coord.run(scs, runs=1))))
    t.start()
    return t


def test_coordinator_requeues_dead_workers_group():
    """A worker dying mid-cell costs exactly that cell (an error record
    naming the host, stamped with the coordinator's device), and the
    unsent remainder of its group is re-stolen by a survivor."""
    scs = [Scenario(arch="a1", task="train", batch=1, seq=s, dtype=d)
           for d in ("fp32", "bf16") for s in (8, 16)]   # 2 groups of 2
    coord = Coordinator(bind="127.0.0.1:0", heartbeat_timeout=30.0,
                        timeout=60.0, connect_timeout=60.0, device="cpu")
    out = {}
    runner = _run_in_thread(coord, scs, out)
    try:
        chan_a = _connect_worker(coord.address, "fakeA")
        job = chan_a.recv(10.0)
        assert job and job["op"] == "run" and job["cell"] == 0
        chan_a.close()
        chan_b = _connect_worker(coord.address, "fakeB")
        for served in range(1, 4):
            job = chan_b.recv(20.0)
            assert job and job["op"] == "run"
            chan_b.send({"op": "result", "cell": job["cell"],
                         "result": _fake_result(job).to_dict(),
                         "stats": {"scenarios_run": served, "model_builds": 1}})
        runner.join(30.0)
        assert not runner.is_alive()
        chan_b.close()
    finally:
        coord.close()
        runner.join(5.0)
    results, stats = out["results"], out["stats"]
    assert [r.name for r in results] == [s.name for s in scs]
    dead, ok = results[0], results[1:]
    assert dead.status == "error" and "fakeA" in dead.error
    assert "disconnect" in dead.error and dead.extra["host"] == "fakeA"
    assert dead.extra["prov_framework"] == "torch" and dead.extra["prov_device"] == "cpu"
    assert all(r.status == "ok" and r.extra["host"] == "fakeB" for r in ok)
    assert all(r.extra["isolated"] for r in results)
    assert stats.scenarios_run == 4 and stats.errors == 1
    assert stats.model_builds == 1


def test_coordinator_requeues_the_group_of_a_worker_that_leaves_after_a_cuda_error():
    """A reply marked ``exiting`` keeps its (error) record, and the rest of
    that worker's group goes to a survivor at once: no cell is sent to the
    leaving worker, none becomes a spurious error record."""
    scs = [Scenario(arch="a1", task="train", batch=1, seq=s) for s in (8, 16, 32)]
    coord = Coordinator(bind="127.0.0.1:0", heartbeat_timeout=30.0,
                        timeout=60.0, connect_timeout=60.0, device="cpu")
    out = {}
    runner = _run_in_thread(coord, scs, out)
    try:
        chan_a = _connect_worker(coord.address, "fakeA")
        job = chan_a.recv(10.0)
        assert job["cell"] == 0
        failed = RunResult.from_error(scs[0], "RuntimeError: CUDA error: an illegal "
                                              "memory access was encountered")
        chan_a.send({"op": "result", "cell": 0, "result": failed.to_dict(),
                     "stats": {"scenarios_run": 1, "errors": 1}, "exiting": True})
        chan_b = _connect_worker(coord.address, "fakeB")
        for _ in range(2):
            job = chan_b.recv(20.0)
            chan_b.send({"op": "result", "cell": job["cell"],
                         "result": _fake_result(job).to_dict(), "stats": {}})
        runner.join(30.0)
        assert not runner.is_alive()
        assert chan_a.recv(2.0) is None and chan_a.eof   # retired, sent nothing more
        chan_a.close()
        chan_b.close()
    finally:
        coord.close()
        runner.join(5.0)
    results, stats = out["results"], out["stats"]
    assert [r.status for r in results] == ["error", "ok", "ok"]
    assert "CUDA error" in results[0].error and results[0].extra["host"] == "fakeA"
    assert [r.extra["host"] for r in results[1:]] == ["fakeB", "fakeB"]
    assert stats.scenarios_run == 1 and stats.errors == 1


def test_coordinator_survives_stray_client_garbage():
    scs = [Scenario(arch="a1", task="train", batch=1, seq=8)]
    coord = Coordinator(bind="127.0.0.1:0", heartbeat_timeout=30.0,
                        timeout=60.0, connect_timeout=60.0, device="cpu")
    out = {}
    runner = _run_in_thread(coord, scs, out)
    try:
        h, _, p = coord.address.rpartition(":")
        stray = socket.create_connection((h, int(p)), timeout=5)
        stray.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        chan = _connect_worker(coord.address, "real")
        job = chan.recv(20.0)
        assert job and job["op"] == "run"
        chan.send({"op": "result", "cell": job["cell"],
                   "result": _fake_result(job).to_dict(),
                   "stats": {"scenarios_run": 1}})
        runner.join(30.0)
        assert not runner.is_alive()
        stray.close()
        chan.close()
    finally:
        coord.close()
        runner.join(5.0)
    (rr,), stats = out["results"], out["stats"]
    assert rr.status == "ok" and rr.extra["host"] == "real"
    assert stats.scenarios_run == 1 and stats.errors == 0


def test_coordinator_reaps_unregistered_pinger():
    scs = [Scenario(arch="a1", task="train", batch=1, seq=8)]
    coord = Coordinator(bind="127.0.0.1:0", heartbeat_timeout=1.0,
                        timeout=60.0, connect_timeout=60.0, device="cpu")
    out = {}
    runner = _run_in_thread(coord, scs, out)
    try:
        h, _, p = coord.address.rpartition(":")
        stray = Channel.over_socket(socket.create_connection((h, int(p)), timeout=5))
        stray.send({"op": "ping"})      # valid JSON, but no register
        time.sleep(1.6)                 # past the registration deadline
        chan = _connect_worker(coord.address, "real")
        job = chan.recv(20.0)
        assert job and job["op"] == "run"
        assert stray.recv(2.0) is None and stray.eof
        chan.send({"op": "result", "cell": job["cell"],
                   "result": _fake_result(job).to_dict(),
                   "stats": {"scenarios_run": 1}})
        runner.join(30.0)
        assert not runner.is_alive()
        stray.close()
        chan.close()
    finally:
        coord.close()
        runner.join(5.0)
    (rr,) = out["results"]
    assert rr.status == "ok" and rr.extra["host"] == "real"


def test_coordinator_reaps_idle_dead_worker_before_feeding():
    scs = [Scenario(arch="a1", task="train", batch=1, seq=8)]
    coord = Coordinator(bind="127.0.0.1:0", heartbeat_timeout=30.0,
                        timeout=60.0, connect_timeout=60.0, device="cpu")
    try:
        out1, out2 = {}, {}
        t1 = _run_in_thread(coord, scs, out1)
        chan_a = _connect_worker(coord.address, "fakeA")
        job = chan_a.recv(10.0)
        chan_a.send({"op": "result", "cell": job["cell"],
                     "result": _fake_result(job).to_dict(),
                     "stats": {"scenarios_run": 1}})
        t1.join(30.0)
        assert not t1.is_alive()
        chan_a.close()                      # dies idle between runs
        chan_b = _connect_worker(coord.address, "fakeB")
        time.sleep(0.2)                     # EOF + register reach the kernel
        t2 = _run_in_thread(coord, scs, out2)
        job = chan_b.recv(20.0)
        assert job and job["op"] == "run"
        chan_b.send({"op": "result", "cell": job["cell"],
                     "result": _fake_result(job).to_dict(),
                     "stats": {"scenarios_run": 2}})
        t2.join(30.0)
        assert not t2.is_alive()
        chan_b.close()
    finally:
        coord.close()
    rr1, rr2 = out1["results"][0], out2["results"][0]
    assert rr1.status == "ok" and rr1.extra["host"] == "fakeA"
    assert rr2.status == "ok" and rr2.extra["host"] == "fakeB"


def test_coordinator_retires_worker_on_unmatched_result():
    scs = [Scenario(arch="a1", task="train", batch=1, seq=s) for s in (8, 16)]
    coord = Coordinator(bind="127.0.0.1:0", heartbeat_timeout=30.0,
                        timeout=60.0, connect_timeout=1.0, device="cpu")
    out = {}
    runner = _run_in_thread(coord, scs, out)
    try:
        chan = _connect_worker(coord.address, "skewed")
        job = chan.recv(10.0)
        assert job and job["op"] == "run"
        chan.send({"op": "result",        # no "cell" echo: off-protocol
                   "result": _fake_result(job).to_dict(), "stats": {}})
        runner.join(30.0)
        assert not runner.is_alive()
        chan.close()
    finally:
        coord.close()
        runner.join(5.0)
    first, second = out["results"]
    assert first.status == "error" and "unmatched result" in first.error
    assert first.extra["host"] == "skewed"
    assert second.status == "error" and "no cluster workers" in second.error


def test_coordinator_errors_out_when_no_workers_connect():
    scs = [Scenario(arch="a1", task="train", batch=1, seq=8)]
    coord = Coordinator(bind="127.0.0.1:0", connect_timeout=0.5, device="cpu")
    try:
        t0 = time.monotonic()
        results, stats = coord.run(scs, runs=1)
    finally:
        coord.close()
    assert time.monotonic() - t0 < 10.0
    assert len(results) == 1 and results[0].status == "error"
    assert "no cluster workers" in results[0].error
    assert stats.errors == 1


# ---- cluster local:2 end-to-end on the CPU ----------------------------------

SERVE_AXES = dict(archs=["gemma-2b"], tasks=("serve",), batches=(3,), seqs=(8,),
                  slots=(2, 3), traces=("uniform", "bursty"))


def test_cluster_local2_matches_serial_on_serve_matrix(tmp_path):
    """cluster="local:2" on a 4-cell serve matrix returns what the serial
    path returns (names in matrix order, every cell ok, tokens
    byte-identical), with extra["host"] stamped and the workers' builds
    in the parent's stats; and its digests are the reference's serial
    ones on the same matrix."""
    matrix = ScenarioMatrix(**SERVE_AXES)
    assert len(matrix) == 4
    serial_rrs = BenchmarkRunner(device="cpu", runs=1, warmup=0).run_matrix(matrix)
    assert all(r.status == "ok" for r in serial_rrs)
    store = ResultStore(str(tmp_path / "s"))
    clustered = BenchmarkRunner(store=store, device="cpu", runs=1, warmup=0)
    try:
        cluster_rrs = clustered.run_matrix(matrix, cluster="local:2")
        pids = clustered.worker_pids()
        assert len(pids) == 2
    finally:
        clustered.close()
    assert clustered.worker_pids() == []
    assert [r.name for r in cluster_rrs] == [r.name for r in serial_rrs]
    assert all(r.status == "ok" for r in cluster_rrs), [r.error for r in cluster_rrs]
    for srr, crr in zip(serial_rrs, cluster_rrs):
        assert crr.extra["tokens"] == srr.extra["tokens"], crr.name
        assert crr.extra["tokens_digest"] == srr.extra["tokens_digest"]
        assert crr.extra["host"].startswith("local") and crr.extra["isolated"]
        assert crr.extra["prov_device"] == "cpu"
    assert clustered.stats.scenarios_run == 4
    assert clustered.stats.model_builds >= 1
    assert clustered.stats.executable_builds >= 2
    assert len(list(store.history())) == 4
    ref_rrs = RefBenchmarkRunner(runs=1, warmup=0).run_matrix(RefScenarioMatrix(**SERVE_AXES))
    assert [r.name for r in ref_rrs] == [r.name for r in cluster_rrs]
    assert [r.extra["tokens_digest"] for r in ref_rrs] == \
        [r.extra["tokens_digest"] for r in cluster_rrs]
