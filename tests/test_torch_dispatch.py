"""The port's dispatch on the CPU: the shard pool (``jobs=N``) and
subprocess isolation against the serial path, with the reference's
statistics; worker crashes as error records; a profiled cell's ``prof_*``
keys through a worker; and the two rules for workers sharing a card,
each with a stub runner (the fence covers a cell's warm pass on a card
and only its timed loop on the CPU; a CUDA error makes the worker reply,
exit, and be respawned for the rest of its group)."""
import fcntl
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.fleet.metrics import registry as metrics_registry
from repro_torch.runner import (BenchmarkRunner, ResultStore, RunResult,
                                RunnerStats, Scenario, ScenarioMatrix,
                                ShardScheduler)
from repro_torch.runner import worker
from repro_torch.runner.pool import _subprocess_env


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread here and in every worker subprocess (they
    inherit the environment): tiny shapes, and the suite runs in parallel."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)


def test_runner_stats_merge():
    a = RunnerStats(model_builds=1, scenarios_run=2, errors=1)
    a.merge({"model_builds": 2, "executable_builds": 3, "bogus_key": 9})
    a.merge(RunnerStats(scenarios_run=1))
    assert a.model_builds == 3 and a.executable_builds == 3
    assert a.scenarios_run == 3 and a.errors == 1
    assert a.to_dict()["model_builds"] == 3


def test_sharded_matrix_matches_serial(tmp_path):
    """jobs=2 returns the same scenario set and statuses as the serial
    path, merges worker stats into the parent, and records shard
    metadata; a second run hits the persistent workers' caches."""
    m = ScenarioMatrix(archs=["gemma-2b"], tasks=("train",), batches=(1,), seqs=(8,),
                       dtypes=("fp32", "bf16"))
    serial_rrs = BenchmarkRunner(device="cpu", runs=1, warmup=0).run_matrix(m)
    store = ResultStore(str(tmp_path / "s"))
    sharded = BenchmarkRunner(store=store, device="cpu", runs=1, warmup=0, jobs=2)
    try:
        shard_rrs = sharded.run_matrix(m)
        rerun = sharded.run_matrix(m)   # same persistent pool, warm caches
        assert len(sharded.worker_pids()) == 2
    finally:
        sharded.close()
    assert sharded.worker_pids() == []
    assert [(r.name, r.status) for r in shard_rrs] == \
        [(r.name, r.status) for r in serial_rrs]
    assert all(r.status == "ok" and r.median_us > 0 for r in shard_rrs)
    assert {r.extra["shard"] for r in shard_rrs} == {0, 1}
    assert all(r.extra["isolated"] and r.extra["prov_device"] == "cpu" for r in shard_rrs)
    assert all(r.status == "ok" for r in rerun)
    assert sharded.stats.model_builds == 2
    assert sharded.stats.executable_builds == 2
    assert sharded.stats.executable_cache_hits == 2
    assert sharded.stats.scenarios_run == 4 and sharded.stats.errors == 0
    assert len(list(store.history())) == 4


def test_shard_worker_crash_becomes_error_records():
    """A dying worker costs its in-flight cell (an error record stamped
    with the pool's device), not the sweep."""
    sched = ShardScheduler(2, runs=1, warmup=0, device="cpu")
    try:
        for w in sched._workers:   # doomed stand-in for a crashy worker
            w.argv = [sys.executable, "-c",
                      "import sys; sys.stdin.readline(); sys.exit(7)"]
        scs = [Scenario(arch="gemma-2b", task="train", batch=1, seq=8),
               Scenario(arch="gemma-2b", task="train", batch=1, seq=8, dtype="bf16")]
        results, stats = sched.run(scs)
    finally:
        sched.close()
    assert [r.status for r in results] == ["error", "error"]
    assert all("exit 7" in r.error for r in results)
    assert {r.extra["shard"] for r in results} == {0, 1}
    assert all(r.extra["prov_device"] == "cpu" for r in results)
    assert stats.scenarios_run == 2 and stats.errors == 2


def test_isolated_run_propagates_worker_stats(tmp_path):
    r = BenchmarkRunner(store=ResultStore(str(tmp_path / "s")), device="cpu",
                        runs=1, warmup=0, isolate=True)
    rr = r.run(Scenario(arch="gemma-2b", task="train", batch=1, seq=8))
    assert rr.status == "ok" and rr.extra["isolated"], rr.error
    assert rr.extra["worker_stats"]["model_builds"] == 1
    assert rr.extra["prov_framework"] == "torch" and rr.extra["prov_device"] == "cpu"
    assert r.stats.model_builds == 1 and r.stats.scenarios_run == 1
    assert r.stats.errors == 0


def test_a_profiled_cell_has_the_same_prof_keys_serially_and_in_a_worker():
    sc = dict(arch="gemma-2b", task="infer_decode", batch=1, seq=8)
    serial = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0,
                             profile=True).run(Scenario(**sc))
    sharded = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0,
                              profile=True, jobs=2)
    try:
        (pooled,) = sharded.run_matrix(ScenarioMatrix(
            archs=[sc["arch"]], tasks=(sc["task"],), batches=(1,), seqs=(8,)))
    finally:
        sharded.close()
    assert serial.status == pooled.status == "ok", pooled.error
    keys = {k for k in serial.extra if k.startswith("prof_")}
    assert keys and {k for k in pooled.extra if k.startswith("prof_")} == keys
    assert pooled.extra["prof_class_us"]["attention"] > 0
    assert "prof_error" not in pooled.extra and "trace_clamp" in pooled.extra


@pytest.mark.parametrize("option", [dict(jobs=2), dict(cluster="local:2"),
                                    dict(isolate=True)])
def test_a_dispatcher_on_a_missing_card_raises_before_it_spawns(option):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="is_available"):
        BenchmarkRunner(**option)


# ---- the two rules for a shared card (stub runners) --------------------------

def _lock_held(path: str) -> bool:
    """Whether another open file description holds the flock on ``path``."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:
        return True
    else:
        fcntl.flock(fd, fcntl.LOCK_UN)
        return False
    finally:
        os.close(fd)


def _ok(sc: Scenario) -> RunResult:
    return RunResult(name=sc.name, bench=sc.bench, arch=sc.arch, task=sc.task,
                     batch=sc.batch, seq=sc.seq, dtype=sc.dtype, mode=sc.mode,
                     status="ok", median_us=1.0, runs=1)


class _FenceProbe:
    """A runner whose every ``run`` records whether the fence is held."""
    reuse = True

    def __init__(self, device: str, lock: str):
        self.device = torch.device(device)
        self.lock = lock
        self.stats = RunnerStats()
        self.held = []

    def run(self, scenario, **kw):
        self.held.append(_lock_held(self.lock))
        self.stats.scenarios_run += 1
        self.stats.executable_cache_hits += 1
        return _ok(scenario)


@pytest.mark.parametrize("device,held", [("cuda", [True, True]), ("cpu", [False, True])])
def test_the_fence_covers_the_warm_pass_on_a_card_and_only_the_timed_loop_on_the_cpu(
        tmp_path, device, held):
    lock = str(tmp_path / "measure.lock")
    probe = _FenceProbe(device, lock)
    sc = Scenario(arch="gemma-2b", task="infer_decode", batch=1, seq=8)
    rr = worker._run_cell(probe, sc, None, None, None, lock)
    assert rr.status == "ok"
    assert probe.held == held            # [warm pass, timed loop]
    assert not _lock_held(lock)
    assert probe.stats.scenarios_run == 1   # one logical execution


STUB_WORKER = r'''
import os, sys
from repro_torch.runner import worker
from repro_torch.runner.results import RunResult
from repro_torch.runner.runner import RunnerStats
import torch

class Stub:
    """seq 8 fails with a CUDA error; every other cell is ok."""
    reuse = True
    device = torch.device("cpu")

    def __init__(self):
        self.stats = RunnerStats()

    def run(self, sc, **kw):
        self.stats.scenarios_run += 1
        if sc.seq == 8:
            self.stats.errors += 1
            rr = RunResult.from_error(sc, "RuntimeError: CUDA error: an illegal "
                                          "memory access was encountered")
        else:
            rr = RunResult(name=sc.name, bench=sc.bench, arch=sc.arch, task=sc.task,
                           batch=sc.batch, seq=sc.seq, dtype=sc.dtype, mode=sc.mode,
                           status="ok", median_us=1.0, runs=1)
        rr.extra["pid"] = os.getpid()
        return rr

worker._build_runner = lambda args: Stub()
sys.exit(worker.main(sys.argv[1:]))
'''


def test_a_cuda_error_makes_the_worker_reply_exit_and_be_respawned():
    scs = [Scenario(arch="gemma-2b", task="infer_decode", batch=1, seq=s)
           for s in (8, 16, 32)]            # one build-key group
    # the worker itself: one reply, marked exiting, then exit code 3
    proc = subprocess.Popen([sys.executable, "-c", STUB_WORKER, "--serve", "--device", "cpu"],
                            env=_subprocess_env(), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jobs = "".join(json.dumps({"op": "run", "scenario": sc.to_dict()}) + "\n"
                   for sc in scs[:2])
    out, err = proc.communicate(jobs, timeout=120)
    replies = [json.loads(line) for line in out.splitlines() if line.strip()]
    assert proc.returncode == worker.CUDA_FAULT_EXIT, err[-2000:]
    assert len(replies) == 1 and replies[0]["exiting"]
    assert replies[0]["result"]["status"] == "error"
    # through the pool: the group's next cells go to a respawned worker
    respawns0 = metrics_registry().snapshot()["counters"].get("pool_respawns_total", 0)
    sched = ShardScheduler(1, runs=1, warmup=0, device="cpu")
    try:
        for w in sched._workers:
            w.argv = [sys.executable, "-c", STUB_WORKER] + w.argv[3:]
        results, stats = sched.run(scs)
    finally:
        sched.close()
    assert [r.status for r in results] == ["error", "ok", "ok"]
    assert "CUDA error" in results[0].error
    pids = [r.extra["pid"] for r in results]
    assert pids[0] != pids[1] == pids[2]
    assert metrics_registry().snapshot()["counters"]["pool_respawns_total"] == respawns0 + 1
    assert stats.scenarios_run == 3 and stats.errors == 1


@pytest.mark.parametrize("error,fault", [
    ("RuntimeError: CUDA error: an illegal memory access was encountered", True),
    ("RuntimeError: flash attention (tc) launch failed: CUDA error 700", True),
    ("OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB", True),
    ("RuntimeError: CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx", True),
    ("NotImplementedError: ssd: the CUDA kernel has no backward yet", False),
    ("ValueError: shapes do not match", False),
])
def test_which_failures_end_a_worker(error, fault):
    runner = _FenceProbe("cpu", "")
    sc = Scenario(arch="gemma-2b", task="train", batch=1, seq=8)
    assert worker._cuda_fault(runner, RunResult.from_error(sc, error)) is fault
    assert worker._cuda_fault(runner, _ok(sc)) is False


FAKE_WORKER = r'''
import json, sys
done = 0
for line in sys.stdin:
    sc = json.loads(line)["scenario"]
    done += 1
    result = dict(schema=1, name=f"{sc['arch']}/{sc['seq']}", bench="", arch=sc["arch"],
                  task=sc["task"], batch=sc["batch"], seq=sc["seq"], dtype=sc["dtype"],
                  mode=sc["mode"], status="ok", median_us=1.0, runs=1)
    print(json.dumps({"op": "result", "result": result,
                      "stats": {"scenarios_run": done, "executable_builds": done}}),
          flush=True)
'''


def test_the_pool_loses_no_result_or_count_under_stealing_with_many_workers():
    """Eight protocol-only workers steal twenty groups under a short switch
    interval: every cell comes back once, in its place, and the workers'
    cumulative counts merge to exactly the work done."""
    scs = [Scenario(arch=f"a{g}", task="infer_decode", batch=1, seq=s)
           for g in range(20) for s in (8, 16)]
    sched = ShardScheduler(8, runs=1, warmup=0, device="cpu", measure_fence=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for w in sched._workers:
            w.argv = [sys.executable, "-c", FAKE_WORKER]
        results, stats = sched.run(scs)
    finally:
        sys.setswitchinterval(old)
        sched.close()
    assert [(r.arch, r.seq) for r in results] == [(sc.arch, sc.seq) for sc in scs]
    assert all(r.status == "ok" for r in results)
    assert stats.scenarios_run == stats.executable_builds == len(scs)
    assert {r.extra["shard"] for r in results} <= set(range(8))
    assert sched.worker_pids() == []
