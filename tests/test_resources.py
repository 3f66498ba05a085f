"""Resource layer: the compiled-program cache's concurrency contract, and
the capability probe (kernel mode per platform, per-kind tuning table).

Cache: a builder running under the ONE global lock would let a
multi-minute fallback-tier compile block every concurrent search's cache
lookup. The contract: builds run outside the lock under per-key events —
a slow key never blocks other keys, a key builds exactly once, and a
raising builder leaves the cache re-attemptable.
"""
import threading
import time

import numpy as np
import pytest

from faiss_tpu.resources import TpuResources


@pytest.fixture()
def res():
    return TpuResources()


def test_slow_build_does_not_block_other_keys(res):
    started = threading.Event()
    release = threading.Event()

    def slow():
        started.set()
        assert release.wait(timeout=30)
        return "slow-value"

    out = {}
    t = threading.Thread(target=lambda: out.__setitem__(
        "slow", res.cached("slow-key", slow)))
    t.start()
    assert started.wait(timeout=10)
    # while the slow build is in flight, a DIFFERENT key must resolve
    t0 = time.monotonic()
    assert res.cached("fast-key", lambda: "fast-value") == "fast-value"
    assert time.monotonic() - t0 < 5.0
    release.set()
    t.join(timeout=30)
    assert out["slow"] == "slow-value"
    assert res.cached("slow-key", lambda: "WRONG") == "slow-value"


def test_same_key_builds_exactly_once_under_contention(res):
    calls = []
    barrier = threading.Barrier(8)

    def builder():
        calls.append(1)
        time.sleep(0.05)
        return "built"

    results = []

    def worker():
        barrier.wait()
        results.append(res.cached("k", builder))

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert results == ["built"] * 8
    assert len(calls) == 1
    assert res.cache_info()["entries"] >= 1


def test_raising_builder_recovers(res):
    with pytest.raises(RuntimeError):
        res.cached("bad", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    # the failed build must not poison the key
    assert res.cached("bad", lambda: "ok-now") == "ok-now"


def test_waiter_retries_after_owner_failure(res):
    """A thread waiting on a key whose owner's builder raises must rebuild
    rather than hang or return a poisoned entry."""
    gate = threading.Event()

    def failing():
        gate.set()
        time.sleep(0.05)
        raise RuntimeError("owner failed")

    def succeeding():
        return "second-try"

    errs, vals = [], []

    def owner():
        try:
            res.cached("flaky", failing)
        except RuntimeError as e:
            errs.append(str(e))

    def waiter():
        assert gate.wait(timeout=10)
        vals.append(res.cached("flaky", succeeding))

    to, tw = threading.Thread(target=owner), threading.Thread(target=waiter)
    to.start()
    tw.start()
    to.join(timeout=30)
    tw.join(timeout=30)
    assert errs == ["owner failed"]
    assert vals == ["second-try"]


# -- capability layer: kernel mode and the per-device-kind tuning table -----

@pytest.mark.parametrize("platform,mode", [
    ("gpu", "compiled"),
    ("cpu", "interpret"),
    ("tpu", None),
    ("rocm", None),
])
def test_kernel_mode_per_platform(platform, mode):
    """Compiled kernels on the GPU, the interpreter on the CPU test
    platform, and no route at all anywhere else."""
    from faiss_tpu.resources import kernel_mode_for

    if mode is None:
        with pytest.raises(ValueError, match="platforms"):
            kernel_mode_for(platform)
    else:
        assert kernel_mode_for(platform) == mode


def test_unknown_gpu_kind_raises():
    """A GPU kind missing from the table must not borrow another card's
    tuning."""
    from faiss_tpu.resources import tuning_for

    with pytest.raises(ValueError, match="no tuning"):
        tuning_for("gpu", "NVIDIA A100-SXM4-80GB")
    assert tuning_for("gpu", "NVIDIA H100 80GB HBM3").chunk_v > 0
    assert tuning_for("cpu", "any cpu").source == "test"


def test_cpu_capabilities_interpret():
    import faiss_tpu

    caps = faiss_tpu.query_device_capabilities()
    assert caps.platform == "cpu" and caps.kernel_mode == "interpret"
    assert caps.interpret
    assert "kernel mode" in caps.describe()
