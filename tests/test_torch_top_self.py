"""top self on the port's capture library: ``tests/test_top_self.py``'s
three cases against the port's `sources_stats`. Every live source of the
port's library reports its capture thread's CPU time, its ring's
occupancy and its loss counters while other gadgets run; the JAX
package's library, loaded in the same process, is a library of its own
whose sources the port never lists.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
from inspektor_gadget_tpu_torch.runtime import LocalRuntime
from inspektor_gadget_tpu_torch.sources.bridge import (SRC_SYNTH_EXEC, NativeCapture,
                                                       native_available, sources_stats)

torch.set_num_threads(2)

needs_native = pytest.mark.skipif(not native_available(), reason="no native lib")


@needs_native
def test_sources_stats_enumerates_live_source():
    src = NativeCapture(SRC_SYNTH_EXEC, seed=3, rate=100_000, vocab=50)
    src.start()
    try:
        time.sleep(0.6)
        mine = [s for s in sources_stats() if s["id"] == src._h]
        assert mine, f"source {src._h} not enumerated in {sources_stats()}"
        s = mine[0]
        assert s["kind_name"] == "synth/exec" and s["produced"] > 0
        assert s["ring_cap"] == 1 << 20 and 0 <= s["ring_len"] <= s["ring_cap"]
        assert s["cpu_ns"] > 0  # a thread generating 100k events/s
        # the counters close only with the producer quiescent
        src.stop()
        s = [x for x in sources_stats() if x["id"] == src._h][0]
        assert s["consumed"] + s["ring_len"] == s["produced"] and s["consumed"] == 0
    finally:
        src.stop()
        src.close()
    assert all(s["id"] != src._h for s in sources_stats()), "destroyed source still listed"


@needs_native
def test_stats_survive_concurrent_stop():
    """`sources_stats` races start/stop without a crash."""
    src = NativeCapture(SRC_SYNTH_EXEC, seed=4, rate=50_000, vocab=10)
    errors = []

    def churn():
        try:
            for _ in range(20):
                src.start()
                time.sleep(0.01)
                src.stop()
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errors.append(e)

    t = threading.Thread(target=churn)
    t.start()
    for _ in range(200):
        sources_stats()
    t.join()
    src.close()
    assert not errors


@needs_native
def test_top_self_observes_running_trace_gadget():
    """trace exec on the native synthetic source beside top self: the
    exec gadget's source is listed with real CPU and ring numbers, and a
    live source of the JAX package's library is not."""
    from inspektor_gadget_tpu.sources import bridge as ref_bridge
    ref_src = (ref_bridge.NativeCapture(ref_bridge.SRC_SYNTH_DNS, seed=5, rate=1000, vocab=5)
               if ref_bridge.native_available() else None)
    desc = get("trace", "exec")
    params = desc.params().to_params()
    params.set("source", "synthetic")
    params.set("rate", "100000")
    tctx = GadgetContext(desc, gadget_params=params, timeout=3.0, device="cpu")
    t = threading.Thread(target=lambda: LocalRuntime().run_gadget(tctx), daemon=True)
    t.start()
    time.sleep(0.8)  # the trace source spins up
    sdesc = get("top", "self")
    sparams = sdesc.params().to_params()
    sparams.set("interval", "500ms")
    sctx = GadgetContext(sdesc, gadget_params=sparams, timeout=1.8, device="cpu")
    arrays = []
    try:
        if ref_src is not None:
            ref_src.start()
        result = LocalRuntime().run_gadget(sctx, on_event_array=arrays.append)
    finally:
        tctx.cancel()
        t.join(4.0)
        if ref_src is not None:
            ref_src.stop()
            ref_src.close()
    assert not result.errors(), result.errors()
    assert arrays, "top self produced no interval arrays"
    rows = [r for tick in arrays for r in tick]
    exec_rows = [r for r in rows if r.source == "synth/exec"]
    assert exec_rows, f"exec source missing from {[r.source for r in rows]}"
    assert any(r.rate > 0 for r in exec_rows) and any(r.cpu_pct > 0 for r in exec_rows)
    assert all("/" in r.ring for r in exec_rows)
    assert not [r for r in rows if r.source == "synth/dns"], "the JAX package's source listed"
