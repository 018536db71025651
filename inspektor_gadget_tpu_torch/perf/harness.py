"""Stage-segmented perf harness: run the ingest pipeline under real
tracing spans and emit a schema-validated PerfRecord (the port's copy of
``inspektor_gadget_tpu/perf/harness.py``).

Where a headline benchmark produces one number, this harness attributes
the same pipeline to its stages: a regression report that says "fold32
got 40% slower" is actionable; "the number went down" is not. Three
pipeline shapes exist:

- ``fused`` (default): pop_folded → h2d_overlap → fused_update. The
  native exporter fills a pinned staging block with folded uint32 keys,
  the depth-2 `H2DStager` overlaps the copy of batch k+1 with the card's
  work on batch k, and `bundle_ingest_step` updates every sketch plane in
  ONE K2 launch (``--invertible`` and ``--quantiles`` add planes to the
  same launch).
- ``classic``: pop → decode → enrich → fold32 → h2d → bundle_update. The
  plain composition, whose entropy update is K1's one-plane plan.
- ``sharded``: pop_folded → h2d_lanes → sharded_update over a list of
  lane devices (lanes may share a device): one pool, stager and K2
  launch a lane a round, `make_bundle_harvest_sharded` and
  `bundle_digest` at harvest ticks.

All three append to the SAME (config, metric, platform) ledger series:
``extra.pipeline`` names the shape, so `bench compare` baselines old
records against new ones instead of forking the series.

Instrumentation reuses the telemetry plane: every stage feeds the
`ig_perf_stage_seconds{stage=...}` histogram once a batch; the run opens
a `perf/run/<config>` span and the first SPAN_BATCHES batches emit a
child span a stage; the record embeds `telemetry.snapshot()` and, when
asked, a Chrome trace of the run (`export_chrome`). Every timed window
ends on a synchronize of the device.

The device is acquired FIRST: `resolve_device` (cuda without a card
raises, nothing falls back to the CPU), then the bounded, retrying
probe, whose trail lands in the record's provenance. On the card the
harness checks that each loop launched its kernel once a step (a lane):
no arm quietly runs a plain version.

Both single-lane arms prefer the seeded NATIVE synthetic source (classic
pops Event structs and pays the Python decode and fold, fused drains the
folded exporter), so fused-vs-classic comparisons isolate the
restructure rather than the generator; the pure-Python source is the
fallback where the capture library does not build, and extra.pipeline
says which implementation ran.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..telemetry import counter, histogram, snapshot
from ..telemetry.tracing import TRACER, export_chrome
from ..utils.logger import get_logger
from .provenance import acquire_device, device_provenance
from .schema import HOST_STAGES, STAGES, make_record

log = get_logger("ig-tpu.perf")

# span-per-stage only for the first N batches; histograms cover the rest
SPAN_BATCHES = 64
# the synthetic stream every arm drains (the headline benchmark's)
SEED, VOCAB, ZIPF_S = 42, 5000, 1.2
# fused steps run before the window (the kernel library's first load)
WARM_STEPS = 2

HARNESS_CONFIGS: dict[str, dict] = {
    # balanced default: big enough to exercise the device plane, small
    # enough to finish on the CPU without scaled-down shapes
    "e2e": dict(batch=1 << 16, depth=4, log2_width=14, hll_p=12,
                entropy_log2_width=10, k=64, seconds=2.0,
                harvest_every=16, sync_every=4, merges=20),
    # bench.py's production shape
    "e2e-prod": dict(batch=1 << 17, depth=4, log2_width=16, hll_p=14,
                     entropy_log2_width=12, k=128, seconds=3.0,
                     harvest_every=32, sync_every=4, merges=50),
    # tier-1 smoke: completes in well under a second on one CPU core
    "tiny": dict(batch=1 << 11, depth=2, log2_width=8, hll_p=6,
                 entropy_log2_width=6, k=8, seconds=0.15,
                 harvest_every=4, sync_every=2, merges=3),
}

_tm_stage = histogram("ig_perf_stage_seconds",
                      "per-batch wall seconds by pipeline stage",
                      ("stage",))
_tm_events = counter("ig_perf_events_total",
                     "events pushed through the perf harness")
_tm_runs = counter("ig_perf_runs_total", "harness runs by config",
                   ("config",))


class _StageClock:
    """Accumulates per-stage seconds/events and feeds the telemetry
    histogram; optionally emits a real tracer span for the stage."""

    def __init__(self, parent_ctx):
        self.seconds = {s: 0.0 for s in STAGES}
        self.calls = {s: 0 for s in STAGES}
        self.samples: dict[str, list[float]] = {"harvest": [], "merge": []}
        self._parent = parent_ctx

    def stage(self, name: str, spans: bool):
        return _StageTimer(self, name, spans)

    def table(self, events: int, rate_stages: tuple[str, ...]) -> dict[str, dict[str, float]]:
        """The record's stages: seconds and calls of every stage that
        ran, events/s where the stage saw every event, p50/p95 ms where
        samples were kept."""
        stages: dict[str, dict[str, float]] = {}
        for s in STAGES:
            if self.calls[s] == 0:
                continue
            st: dict[str, float] = {"seconds": round(self.seconds[s], 6),
                                    "calls": self.calls[s]}
            if s in rate_stages:
                st["ev_per_s"] = round(events / max(self.seconds[s], 1e-9), 1)
            if self.samples.get(s):
                ms = np.asarray(self.samples[s]) * 1000.0
                st["ms_p50"] = round(float(np.percentile(ms, 50)), 3)
                st["ms_p95"] = round(float(np.percentile(ms, 95)), 3)
            stages[s] = st
        return stages


class _StageTimer:
    __slots__ = ("_clock", "_name", "_span", "_t0")

    def __init__(self, clock: _StageClock, name: str, spans: bool):
        self._clock = clock
        self._name = name
        self._span = (TRACER.span(f"perf/{name}", parent=clock._parent)
                      if spans else None)

    def __enter__(self):
        if self._span is not None:
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._span is not None:
            self._span.__exit__(*exc)
        self._clock.seconds[self._name] += dt
        self._clock.calls[self._name] += 1
        if self._name in self._clock.samples:
            self._clock.samples[self._name].append(dt)
        _tm_stage.labels(stage=self._name).observe(dt)


def _fold32(keys64: np.ndarray) -> np.ndarray:
    k = keys64.astype(np.uint64, copy=False)
    return ((k >> np.uint64(32)) ^ (k & np.uint64(0xFFFFFFFF))).astype(
        np.uint32)


def _sync(dev: torch.device) -> None:
    """Wait for the device: the end of every timed window."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host uint32 (or bool) lane as a device tensor (uint32 as int32 bits)."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _launches() -> tuple[int, int]:
    """(K2, K1) launches so far: each wrapper counts where it launches."""
    from ..ops import kernels as K
    return K.fused_planes.launches, K.histogram.launches


def _require_launches(dev: torch.device, before: tuple[int, int], k2: int, k1: int,
                      what: str) -> None:
    """On the card, a loop of `what` must have launched exactly `k2` K2s
    and `k1` K1s since `before`; a plain version run in a kernel's place
    shows here. The CPU launches nothing."""
    if dev.type != "cuda":
        return
    now = _launches()
    got = (now[0] - before[0], now[1] - before[1])
    if got != (k2, k1):
        raise RuntimeError(f"{what}: launched K2 {got[0]} and K1 {got[1]} times, "
                           f"expected K2 {k2} and K1 {k1}")


def _native_source():
    """The seeded native synthetic source, or None where the capture
    library does not build (the pure-Python fallback is then used)."""
    from ..sources.bridge import SRC_SYNTH_EXEC, NativeCapture, native_available
    if not native_available():
        log.debug("native synthetic source unavailable; pure-python fallback")
        return None
    return NativeCapture(SRC_SYNTH_EXEC, seed=SEED, vocab=VOCAB, zipf_s=ZIPF_S)


def _write_trace(trace_out: str | None, trace_id: str) -> str | None:
    if not trace_out:
        return None
    doc = export_chrome(TRACER.export(trace_id=trace_id))
    with open(trace_out, "w", encoding="utf-8") as f:
        f.write(json.dumps(doc, default=str))
    return trace_out


def run_harness(config: str = "e2e", *, device: str | torch.device = "cuda",
                seconds: float | None = None,
                probe_timeout: float | None = None,
                probe_attempts: int | None = None,
                probe_horizon: float | None = None,
                trace_out: str | None = None,
                replay: str | None = None,
                pipeline: str = "fused",
                chips: int = 1,
                lanes: list | None = None,
                invertible: bool = False,
                quantiles: bool = False) -> dict:
    """Run one harness config on `device`; returns a validated PerfRecord.

    `replay` points the host side at a capture journal (the port's or
    the reference's) instead of the synthetic source: the measured input
    becomes reproducible input-for-input (the recorded batch sequence,
    cycled through the window) and the journal's content digest lands in
    the record's provenance.

    `pipeline` picks the hot-path shape (see the module note). The
    sharded arm runs `chips` lanes, the first `chips` of `lanes` (a list
    of devices; default every local card, or the one CPU); lanes may
    share a device, so `chips` is bounded by the lanes given.

    `invertible` adds the invertible heavy-key plane to the bundle (K2
    carries it on the hot path; the record stays in the same series with
    extra.invertible naming the shape). Two extra stages land in the
    record: inv_decode times a real decode of the live state at every
    harvest tick, and inv_update a post-loop micro-measurement of the
    standalone invertible update.

    `quantiles` adds the DDSketch latency plane to the bundle and a
    synthetic ns-domain value lane to the staging block (fused pipeline
    only); a post-loop qt_update stage micro-measures the standalone
    DDSketch fold at this batch shape.

    The caller decides whether the record lands in the ledger
    (cli/bench.py appends by default; tests pass their own path)."""
    cfg = HARNESS_CONFIGS.get(config)
    if cfg is None:
        raise ValueError(f"unknown harness config {config!r} "
                         f"(have: {', '.join(sorted(HARNESS_CONFIGS))})")
    if pipeline not in ("fused", "classic", "sharded"):
        raise ValueError(f"unknown pipeline {pipeline!r} "
                         "(have: fused, classic, sharded)")
    if pipeline != "sharded" and chips != 1:
        raise ValueError("--chips needs pipeline=sharded (the fused and "
                         "classic arms are single-chip by construction)")
    if pipeline == "sharded" and replay:
        raise ValueError("pipeline=sharded does not take --replay yet "
                         "(replay determinism through the sharded path is "
                         "covered by the operator tier)")
    if invertible and pipeline == "sharded":
        raise ValueError("--invertible measures the single-chip fused/"
                         "classic arms (the sharded arm's per-chip number "
                         "comes from the same fused step)")
    if quantiles and pipeline != "fused":
        raise ValueError("--quantiles measures the fused arm (the value "
                         "lane rides the folded staging block; classic "
                         "has no values input, sharded's per-chip number "
                         "comes from the same fused step)")
    dev, acquired = acquire_device(device, timeout=probe_timeout,
                                   attempts=probe_attempts, horizon=probe_horizon)
    _tm_runs.labels(config=config).inc()
    window = cfg["seconds"] if seconds is None else float(seconds)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    requested = str(device)

    if pipeline == "sharded":
        return _run_sharded(config, cfg, window, chips, lanes, dev, acquired, platform,
                            requested, trace_out)

    from ..ops import bundle_merge, entropy_estimate, hll_estimate, topk_values
    from ..ops.sketches import bundle_ingest_step, bundle_init, bundle_update
    from ..sources.synthetic import PySyntheticSource

    batch_n = cfg["batch"]
    replay_src = None
    if replay:
        from ..capture.replay import ReplaySource
        replay_src = ReplaySource(replay, cycle=True)
        if not len(replay_src):
            raise ValueError(f"{replay}: journal carries no batches to "
                             "replay through the harness")
        src = replay_src
        batch_n = max(b.capacity for b in replay_src.batches)
    else:
        src = PySyntheticSource(seed=SEED, vocab=VOCAB, batch_size=batch_n)

    # both arms prefer the native synthetic source so that the fused-vs-
    # classic comparison isolates the restructure, not the generator
    native_gen = _native_source() if replay_src is None else None

    inv_rows = 3 if invertible else 0
    inv_lb = min(12, cfg["log2_width"]) if invertible else 12

    def new_bundle():
        return bundle_init(depth=cfg["depth"], log2_width=cfg["log2_width"],
                           hll_p=cfg["hll_p"],
                           entropy_log2_width=cfg["entropy_log2_width"],
                           k=cfg["k"], inv_rows=inv_rows,
                           inv_log2_buckets=inv_lb, quantiles=quantiles, device=dev)

    # synthetic ns-domain latencies for the value lane: made once, copied
    # into the pinned block a batch (the host cost the operator pays
    # filling the lane from a batch column)
    qt_lat = None
    if quantiles:
        from .quantile_bench import _latencies
        qt_lat = np.minimum(_latencies(batch_n),
                            np.float32(0xFFFFFFFF)).astype(np.uint32)

    def fused_step(bundle, k, w, v=None):
        return bundle_ingest_step(bundle, k, k, k, w, None, v if quantiles else None)

    with TRACER.span(f"perf/run/{config}",
                     attrs={"config": config, "platform": platform,
                            "batch": batch_n,
                            "pipeline": pipeline}) as run_span:
        clock = _StageClock(run_span.context)

        pool = stager = pstats = None
        if pipeline == "fused":
            from ..sources.staging import H2DStager, PinnedBufferPool
            from ..telemetry.pipeline import PipelineStats
            pool = PinnedBufferPool(batch_n, lanes=3 if quantiles else 2,
                                    max_free=4, device=dev)
            # the operator's instrumented stager: the record carries the
            # starved fraction and per-stage lag quantiles
            pstats = PipelineStats(f"perf.{config}")
            stager = H2DStager(pool, depth=2, device=dev, stats=pstats)

        def fill_folded(block) -> tuple[int, int]:
            """Fill a pinned block's key and weights lanes (and the value
            lane); returns (events, drops) of the batch."""
            b = block.numpy()
            if native_gen is not None:
                # the native exporter fills the pinned lane directly: no
                # Event structs, no decode, no fold pass
                native_gen.generate_folded(batch_n, out=b[0])
                n, dropped = batch_n, 0
                b[1][:] = 1
            else:
                eb = src.generate(batch_n)
                n, dropped = eb.count, eb.drops
                b[0][:n] = _fold32(np.asarray(eb.cols["key_hash"][:n], dtype=np.uint64))
                b[0][n:] = 0
                b[1][:n] = 1
                b[1][n:] = 0
            if quantiles:
                b[2][:] = qt_lat
            return n, dropped

        # warm: the kernel library's first load and the source's ramp,
        # outside every measured window. The classic arm warms every
        # distinct batch shape a replay journal carries; the fused arm
        # re-pads every batch into one fixed-capacity pinned block.
        bundle = new_bundle()
        warm_before = _launches()
        if pipeline == "fused":
            blk = pool.get()
            fill_folded(blk)
            staged = stager.stage(blk, tuple(blk[j] for j in range(pool.lanes)))
            for _ in range(WARM_STEPS):
                bundle, tok = fused_step(bundle, *staged)
            stager.fence(tok)
            _sync(dev)
            stager.drain()
            _require_launches(dev, warm_before, WARM_STEPS, 0, "the fused warm-up")
        else:
            if replay_src is not None:
                warm_batches = list({b.capacity: b for b in replay_src.batches}.values())
            elif native_gen is not None:
                warm_batches = [native_gen.generate(batch_n)]
            else:
                warm_batches = [src.generate(batch_n)]
            for warm in warm_batches:
                wk = _to_device(_fold32(np.asarray(warm.cols["key_hash"])), dev)
                wm = _to_device(warm.mask(), dev)
                for _ in range(WARM_STEPS):
                    bundle_update(bundle, wk, wk, wk, wm)
            _sync(dev)
            _require_launches(dev, warm_before, 0, WARM_STEPS * len(warm_batches),
                              "the classic warm-up")
        if replay_src is not None:
            replay_src.reset()  # measure the recorded sequence from 0
            bundle = new_bundle()

        steps = 0
        events = 0
        drops = 0
        loop_before = _launches()
        t_loop = time.perf_counter()
        deadline = t_loop + window
        while time.perf_counter() < deadline:
            spans = steps < SPAN_BATCHES
            if pipeline == "fused":
                t_gen = time.perf_counter()
                with clock.stage("pop_folded", spans):
                    block = pool.get()
                    n, dropped = fill_folded(block)
                    drops += dropped
                t_pop = time.perf_counter()
                with clock.stage("h2d_overlap", spans):
                    # copy on the stager's side stream; blocks only when
                    # the ring is a full depth ahead of the card
                    staged = stager.stage(block, tuple(block[j] for j in range(pool.lanes)))
                # batch-grain watermarks, the operator's clocks: host lag
                # = pop − generation, device lag = dispatch − pop
                pstats.note_host_lag(t_pop - t_gen)
                pstats.note_device_lag(time.perf_counter() - t_pop)
                with clock.stage("fused_update", spans):
                    bundle, tok = fused_step(bundle, *staged)
                    stager.fence(tok)
                    if (steps + 1) % cfg["sync_every"] == 0:
                        _sync(dev)
            else:
                with clock.stage("pop", spans):
                    batch = (native_gen.generate(batch_n) if native_gen is not None
                             else src.generate(batch_n))
                with clock.stage("decode", spans):
                    keys64 = np.ascontiguousarray(
                        np.asarray(batch.cols["key_hash"], dtype=np.uint64))
                with clock.stage("enrich", spans):
                    mask_np = batch.mask()
                    drops += batch.drops
                with clock.stage("fold32", spans):
                    k32 = _fold32(keys64)
                with clock.stage("h2d", spans):
                    k = _to_device(k32, dev)
                    mask = _to_device(mask_np, dev)
                with clock.stage("bundle_update", spans):
                    bundle_update(bundle, k, k, k, mask)
                    # bound the async backlog so the wall clock covers
                    # the card's work, not just the dispatch
                    if (steps + 1) % cfg["sync_every"] == 0:
                        _sync(dev)
                n = batch.count
            steps += 1
            events += n
            _tm_events.inc(n)
            if steps % cfg["harvest_every"] == 0:
                with clock.stage("harvest", spans):
                    _hh_keys, hh_counts = topk_values(bundle.topk)
                    hh_counts.cpu()
                    float(hll_estimate(bundle.hll))
                    float(entropy_estimate(bundle.entropy))
                if invertible:
                    # a REAL decode of the live state a harvest tick: the
                    # cost a consumer of decoded heavy keys pays (device
                    # peel + host finisher)
                    with clock.stage("inv_decode", spans):
                        from ..ops.invertible import inv_decode
                        inv_decode(bundle.inv, device_sweeps=2, cap=512)
        final_stage = "fused_update" if pipeline == "fused" else "bundle_update"
        with clock.stage(final_stage, steps < SPAN_BATCHES):
            _sync(dev)
            if stager is not None:
                stager.drain()
        elapsed = time.perf_counter() - t_loop
        if pipeline == "fused":
            _require_launches(dev, loop_before, steps, 0, "the fused arm")
        else:
            _require_launches(dev, loop_before, 0, steps, "the classic arm")
        if native_gen is not None:
            native_gen.close()

        # merge latency at this config's shape (the cluster's wire plane)
        other = new_bundle()
        bundle_merge(bundle, other)
        _sync(dev)
        for _ in range(cfg["merges"]):
            with clock.stage("merge", True):
                bundle_merge(bundle, other)
                _sync(dev)

        if invertible:
            # the standalone invertible update at this batch shape: K2
            # carries these planes on the hot path, so this isolates what
            # the plane itself costs a batch
            from ..ops.invertible import inv_init, inv_update
            inv_s = inv_init(inv_rows, inv_lb, device=dev)
            ik = _to_device(np.arange(1, batch_n + 1, dtype=np.uint32), dev)
            iw = torch.ones(batch_n, dtype=torch.int32, device=dev)
            inv_update(inv_s, ik, iw)
            _sync(dev)
            for _ in range(cfg["merges"]):
                with clock.stage("inv_update", True):
                    inv_update(inv_s, ik, iw)
                    _sync(dev)

        if quantiles:
            # the standalone DDSketch fold at this batch shape (the
            # inv_update pattern)
            from ..ops.quantiles import dd_init, dd_update
            qt_s = dd_init(0.01, 2048, min_value=1.0, device=dev)
            qv = torch.from_numpy(qt_lat.astype(np.float32)).to(dev)
            dd_update(qt_s, qv)
            _sync(dev)
            for _ in range(cfg["merges"]):
                with clock.stage("qt_update", True):
                    dd_update(qt_s, qv)
                    _sync(dev)

        # the accuracy audit plane's cost at this batch shape: a post-loop
        # micro-measurement of the bottom-k shadow-sample fold, projected
        # onto this run's wall clock. extra.audit_overhead is the fraction
        # of ingest time `audit-sample > 0` would have added here.
        from ..ops.accuracy import ShadowSample
        audit_keys64 = np.arange(1, batch_n + 1, dtype=np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        audit_sh = ShadowSample(1024)
        audit_sh.update(_fold32(audit_keys64))  # warm: fill the reservoir
        audit_reps = max(int(cfg["merges"]), 8)
        t_a = time.perf_counter()
        for _ in range(audit_reps):
            with clock.stage("audit_feed", True):
                audit_sh.update(_fold32(audit_keys64))
        audit_s = max(time.perf_counter() - t_a, 1e-9)
        audit_proj = (audit_s / audit_reps) * max(steps, 1)
        audit_overhead = audit_proj / max(elapsed + audit_proj, 1e-9)

        run_span.set_attr("events", events)
        run_span.set_attr("ev_per_s", round(events / max(elapsed, 1e-9), 1))
        trace_id = run_span.context.trace_id

    value = events / max(elapsed, 1e-9)
    stages = clock.table(events, ("pop", "decode", "enrich", "fold32", "pop_folded", "h2d",
                                  "h2d_overlap", "bundle_update", "fused_update"))
    trace_file = _write_trace(trace_out, trace_id)
    prov = device_provenance(dev, acquired)
    extra_fields: dict = {}
    # the host-plane aggregate: pop_folded→h2d_overlap against
    # pop→decode→enrich→fold32→h2d stage totals
    host_secs = sum(clock.seconds[s] for s in HOST_STAGES[pipeline])
    extra_fields["host_plane_ev_per_s"] = round(events / max(host_secs, 1e-9), 1)
    impl = ("native" if native_gen is not None
            else "replay" if replay_src is not None else "py")
    inv_tag = ("+inv" if invertible else "") + ("+qt" if quantiles else "")
    if pipeline == "fused":
        extra_fields["pipeline"] = (
            f"pop_folded({'py-fold' if impl == 'py' else impl})"
            f"->h2d_overlap(depth2)->fused_update{inv_tag}")
    else:
        extra_fields["pipeline"] = (
            f"pop({impl})->decode->enrich->fold32->h2d"
            f"->bundle_update{inv_tag}")
    if invertible:
        extra_fields["invertible"] = True
        extra_fields["inv_geometry"] = f"{inv_rows}x2^{inv_lb}"
    if quantiles:
        extra_fields["quantiles"] = True
        extra_fields["qt_geometry"] = "2048@alpha0.01"
    extra_fields["audit_overhead"] = round(audit_overhead, 4)
    if pstats is not None:
        psnap = pstats.snapshot()
        pstats.unregister()  # return the shared gauges to baseline
        extra_fields["starved_fraction"] = round(psnap["starved_ratio"], 4)
        extra_fields["stall_s"] = round(psnap["stall_s"], 6)
        extra_fields["stage_lag"] = {
            stage: {"p50_s": round(row["p50_s"], 9),
                    "p99_s": round(row["p99_s"], 9)}
            for stage, row in psnap["stages"].items()}
    if replay_src is not None:
        # the journal digest is part of the number's meaning: same config
        # + same digest → directly comparable records
        prov["replay"] = {"journal": replay, "digest": replay_src.digest,
                          "batches": len(replay_src)}
        extra_fields["replay_digest"] = replay_src.digest
    rec = make_record(
        config=f"harness.{config}",
        metric="sketch_ingest_throughput_e2e",
        unit="events/sec/chip",
        value=round(value, 1),
        stages=stages,
        provenance=prov,
        telemetry=snapshot(),
        extra={"batch": batch_n, "steps": steps, "events": events,
               "drops": drops, "elapsed_s": round(elapsed, 3),
               "window_s": window, "trace_id": trace_id,
               "requested_platform": requested, **extra_fields},
        trace_file=trace_file,
    )
    log.info("harness %s: %.1f ev/s on %s (%d events, %d steps)",
             config, value, platform, events, steps)
    return rec


def _run_sharded(config: str, cfg: dict, window: float, chips: int, lanes: list | None,
                 dev: torch.device, acquired: dict, platform: str, requested: str,
                 trace_out: str | None) -> dict:
    """The chips-scaling arm: pop_folded → h2d_lanes → sharded_update
    over `chips` lane devices. The config batch SPLITS across lanes (lane
    batch = batch/chips, loudly validated), so every scale point pushes
    the same events a round and the curve isolates the sharding, not the
    batch shape.

    The headline value is the DEVICE-PLANE AGGREGATE: one lane's update
    throughput (measured on one lane's shape in isolation) × chips. Lanes
    share no hot-path state (each runs its own K2 step), so the aggregate
    is the capacity concurrent lanes expose. Lanes that share a device
    take turns on it, so the record also carries the serialized
    wall-clock numbers (extra.e2e_wall_ev_per_s,
    extra.device_plane_wall_ev_per_s) and names the aggregation formula
    in extra.aggregation.
    """
    from ..operators.tpusketch import _lane_devices
    from ..ops.sketches import (bundle_digest, bundle_ingest_step, bundle_init,
                                bundle_stack_sharded, make_bundle_harvest_sharded,
                                make_bundle_ingest_sharded)
    from ..parallel.mesh import ingest_mesh
    from ..sources.staging import H2DStager, PinnedBufferPool
    from ..sources.synthetic import PySyntheticSource

    avail = list(lanes) if lanes is not None else _lane_devices(None, dev)
    if not 1 <= chips <= len(avail):
        raise ValueError(f"chips={chips} out of range for this host "
                         f"({len(avail)} local device(s))")
    batch_n = cfg["batch"]
    if batch_n % chips:
        raise ValueError(f"config batch {batch_n} is not divisible by "
                         f"chips={chips} — lanes need equal SoA shards")
    lane_n = batch_n // chips
    mesh = ingest_mesh(chips, avail)
    like = bundle_init(depth=cfg["depth"], log2_width=cfg["log2_width"],
                       hll_p=cfg["hll_p"],
                       entropy_log2_width=cfg["entropy_log2_width"],
                       k=cfg["k"], device=mesh[0])
    step = make_bundle_ingest_sharded(mesh, like)
    harvest = make_bundle_harvest_sharded(mesh, like)
    stacked = bundle_stack_sharded(like, mesh)

    native_gen = _native_source()
    src = None if native_gen is not None else PySyntheticSource(
        seed=SEED, vocab=VOCAB, batch_size=lane_n)

    pools = [PinnedBufferPool(lane_n, lanes=2, max_free=4, device=d, lane=k)
             for k, d in enumerate(mesh)]
    stagers = [H2DStager(pools[k], depth=2, device=d) for k, d in enumerate(mesh)]
    no_drops = [None] * chips
    lane_devs = list(dict.fromkeys(mesh))

    def sync() -> None:
        for d in lane_devs:
            _sync(d)

    def fill_block(block) -> None:
        b = block.numpy()
        if native_gen is not None:
            native_gen.generate_folded(lane_n, out=b[0])
        else:
            eb = src.generate(lane_n)
            b[0][:eb.count] = _fold32(np.asarray(eb.cols["key_hash"][:eb.count],
                                                 dtype=np.uint64))
            b[0][eb.count:] = 0
        b[1][:] = 1

    def fill_round() -> list:
        blocks = []
        for k in range(chips):
            block = pools[k].get()
            fill_block(block)
            blocks.append(block)
        return blocks

    def stage_round(blocks) -> tuple[list, list]:
        staged = [stagers[k].stage(b, (b[0], b[1])) for k, b in enumerate(blocks)]
        return [s[0] for s in staged], [s[1] for s in staged]

    def fence(tokens) -> None:
        for st, tok in zip(stagers, tokens):
            st.fence(tok)

    # warm: the kernel library's first load and the harvest, outside the window
    warm_before = _launches()
    keys, wts = stage_round(fill_round())
    stacked, tok = step(stacked, keys, keys, keys, wts, no_drops)
    fence(tok)
    sync()
    harvest(stacked)
    for st in stagers:
        st.drain()
    _require_launches(dev, warm_before, chips, 0, "the sharded warm-up")

    with TRACER.span(f"perf/run/{config}",
                     attrs={"config": config, "platform": platform,
                            "batch": batch_n, "pipeline": "sharded",
                            "chips": chips}) as run_span:
        clock = _StageClock(run_span.context)
        steps_n = 0
        events = 0
        loop_before = _launches()
        t_loop = time.perf_counter()
        deadline = t_loop + window
        while time.perf_counter() < deadline:
            spans = steps_n < SPAN_BATCHES
            with clock.stage("pop_folded", spans):
                blocks = fill_round()
            with clock.stage("h2d_lanes", spans):
                keys, wts = stage_round(blocks)
            with clock.stage("sharded_update", spans):
                stacked, tok = step(stacked, keys, keys, keys, wts, no_drops)
                fence(tok)
                if (steps_n + 1) % cfg["sync_every"] == 0:
                    sync()
            steps_n += 1
            events += batch_n
            _tm_events.inc(batch_n)
            if steps_n % cfg["harvest_every"] == 0:
                with clock.stage("harvest", spans):
                    bundle_digest(harvest(stacked)).cpu()
        with clock.stage("sharded_update", steps_n < SPAN_BATCHES):
            sync()
            for st in stagers:
                st.drain()
        elapsed = time.perf_counter() - t_loop
        _require_launches(dev, loop_before, steps_n * chips, 0, "the sharded arm")

        # device-plane loops on pre-staged tensors (no host generation):
        # (a) one lane's fused update in isolation, the per-chip number
        # every scale point shares; (b) the sharded step's wall rate, what
        # lanes taking turns on shared devices sustain. Each window is at
        # least 0.5 s: the tiny config's 0.15 s window under-samples it.
        dev_win = max(min(window, 1.0), 0.5)
        scratch = np.empty(lane_n, dtype=np.uint32)
        if native_gen is not None:
            native_gen.generate_folded(lane_n, out=scratch)
        else:
            scratch[:] = np.arange(1, lane_n + 1, dtype=np.uint32)
        one_keys = _to_device(scratch, mesh[0])
        one_w = torch.ones(lane_n, dtype=torch.int32, device=mesh[0])
        dbundle = bundle_init(depth=cfg["depth"], log2_width=cfg["log2_width"],
                              hll_p=cfg["hll_p"], entropy_log2_width=cfg["entropy_log2_width"],
                              k=cfg["k"], device=mesh[0])
        dev_before = _launches()
        bundle_ingest_step(dbundle, one_keys, one_keys, one_keys, one_w)
        _sync(mesh[0])
        dsteps = 0
        t0 = time.perf_counter()
        while True:
            bundle_ingest_step(dbundle, one_keys, one_keys, one_keys, one_w)
            dsteps += 1
            if dsteps % 8 == 0:
                _sync(mesh[0])
                if time.perf_counter() - t0 >= dev_win:
                    break
        _sync(mesh[0])
        per_chip = dsteps * lane_n / (time.perf_counter() - t0)

        keys, wts = stage_round(fill_round())
        wsteps = 0
        t0 = time.perf_counter()
        while True:
            stacked, tok = step(stacked, keys, keys, keys, wts, no_drops)
            wsteps += 1
            if wsteps % 8 == 0:
                sync()
                if time.perf_counter() - t0 >= dev_win:
                    break
        fence(tok)
        sync()
        device_wall = wsteps * batch_n / (time.perf_counter() - t0)
        for st in stagers:
            st.drain()
        _require_launches(dev, dev_before, 1 + dsteps + wsteps * chips, 0,
                          "the device-plane loops")
        if native_gen is not None:
            native_gen.close()

        aggregate = per_chip * chips
        run_span.set_attr("events", events)
        run_span.set_attr("device_plane_aggregate_ev_per_s", round(aggregate, 1))
        trace_id = run_span.context.trace_id

    stages = clock.table(events, ("pop_folded", "h2d_lanes", "sharded_update"))
    trace_file = _write_trace(trace_out, trace_id)
    prov = device_provenance(dev, acquired)
    impl = "native" if native_gen is not None else "py-fold"
    rec = make_record(
        config=f"harness.{config}",
        metric="sketch_ingest_device_plane_aggregate",
        unit="events/sec",
        value=round(aggregate, 1),
        stages=stages,
        provenance=prov,
        telemetry=snapshot(),
        extra={
            "batch": batch_n, "lane_batch": lane_n, "chips": chips,
            "steps": steps_n, "events": events,
            "elapsed_s": round(elapsed, 3), "window_s": window,
            "trace_id": trace_id, "requested_platform": requested,
            "pipeline": f"pop_folded({impl})->h2d_lanes(x{chips})->sharded_update",
            "per_chip_ev_per_s": round(per_chip, 1),
            "device_plane_wall_ev_per_s": round(device_wall, 1),
            "e2e_wall_ev_per_s": round(events / max(elapsed, 1e-9), 1),
            "aggregation": ("per_chip_ev_per_s x chips (lanes share no "
                            "hot-path state; lanes that share a device (the "
                            "CPU's, or one card's) take turns on it — the "
                            "wall rates beside this are the serialized "
                            "measurement)"),
        },
        trace_file=trace_file,
    )
    log.info("harness %s sharded x%d: %.1f ev/s aggregate (%.1f/chip, wall %.1f) on %s",
             config, chips, aggregate, per_chip, device_wall, platform)
    return rec
