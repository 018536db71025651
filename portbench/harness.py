"""One run of one cell: the window drives the port's
``LocalRuntime().run_gadget(ctx, on_batch=...)`` with the tpusketch
operator on, fed by this package's seeded generator, then checks every
output the run produced against the plain reference.

The feed replaces the gadget's source: a gadget description whose
``new_instance`` returns the registered gadget with its source factory
(`_make_source`) answering this package's feed. The run loop, the
operator chain and the operator are the program's, as a user's
``ig-tpu-torch trace <gadget> --tpusketch-enable true`` runs them.

Host clocks are ``time.perf_counter``. A batch's fold completes on the
card when a CUDA event recorded right after its handler returns
completes; events map onto the host clock through one anchor event.

A traced run (``trace``) measures its window exactly as an untraced run
does, and then runs on under ``torch.profiler`` for a slice of the same
traffic: the profiler's own cost never reaches a host-clock or counter
reading of the window, and the device figures come from the slice.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time

import numpy as np
import torch

from . import check, devtrace, roofline
from .spec import Spec
from .stream import BacklogFeed, EventPool, OpenLoopFeed

PROF_SPAN_S = 3.0  # a traced run's profiled slice, at most
PROF_LEAD_S = 2.0  # how long the slice waits for the window's last chunks


class _FeedSource:
    """The source object the gadget's run loop pops."""

    def __init__(self, run: "Run"):
        self._run = run

    def pop(self):
        return self._run.pop()

    def stop(self) -> None:
        pass

    def close(self) -> None:
        pass

    def vocab_lookup(self, key_hash: int) -> str:
        return self._run.name_of(int(key_hash))


def _histogram(name: str, **labels):
    from inspektor_gadget_tpu_torch.telemetry import REGISTRY
    for fam in REGISTRY.families():
        if fam.name == name:
            return fam.labels(**labels)
    return None


class Run:
    def __init__(self, spec: Spec, cell_name: str, seed: int, seconds: float, *,
                 trace: bool = False, device: str = "cuda", t_proc0: float | None = None,
                 traffic_overrides: dict | None = None):
        self.spec = spec
        self.cell = spec.cell(cell_name)
        self.cfg = spec.config(self.cell["config"])
        self.traffic = dict(spec.traffic(self.cell["traffic"]))
        self.traffic.update(traffic_overrides or {})
        self.seed = int(seed) % (1 << 63)
        self.seconds = float(seconds)
        self.trace = trace
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.t_proc0 = time.perf_counter() if t_proc0 is None else t_proc0
        self.prof_span = min(PROF_SPAN_S, 0.4 * self.seconds)
        self.phase = "warmup"
        self.t0 = self.t_end = math.inf
        self.first_window_batch = None
        self.end_batch = None
        self.pops: list[tuple[float, float]] = []   # per logged batch: pop start, end
        self.done: list[tuple[float, object]] = []  # per logged batch: on_batch, event
        self.summaries: list[dict] = []
        self.seals: list[dict] = []
        self.answers: list[dict] = []
        self.harvest_ms: list[dict] = []
        self.seal_ms: list[dict] = []
        self.counters0 = self.counters1 = None
        self.prof = None
        self.prof_t = [math.inf, math.inf]
        self.inst = None
        self._seen_summaries = self._seen_seals = 0

    # -- the feed -----------------------------------------------------------------

    def name_of(self, key_hash: int) -> str:
        i = int(np.searchsorted(self._sorted_hashes, key_hash))
        if i < len(self._sorted_hashes) and int(self._sorted_hashes[i]) == key_hash:
            return f"{self.cfg['stream']['name_prefix']}{int(self._hash_order[i])}"
        return ""

    def _counters(self) -> dict:
        g = self.cfg["gadget"]
        out = {}
        for key, name, labels in (("enrich", "ig_operator_enrich_seconds",
                                   {"operator": "tpusketch"}),
                                  ("harvest", "ig_tpusketch_harvest_seconds", {"gadget": g})):
            h = _histogram(name, **labels)
            out[key] = (h.sum, h.count) if h is not None else (0.0, 0)
        return out

    def _profile_tick(self, now: float, ready: bool = True) -> None:
        """Start the profiled slice (once `ready`), or stop it once it
        has run `prof_span` seconds; then the run goes on to its end."""
        if self.prof is None:
            if not ready:
                return
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.start()
            self.prof_t[0] = time.perf_counter()
        elif now >= self.prof_t[0] + self.prof_span:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.prof is not None and self.prof_t[1] == math.inf:
            if self.cuda:
                torch.cuda.synchronize()
            self.prof_t[1] = time.perf_counter()
            self.prof.stop()
            self.phase = "ended" if self.backlog else "drain"

    def _open_window(self, now: float) -> None:
        self.phase = "window"
        self.t0 = now
        self.t_end = now + self.seconds
        self.first_window_batch = len(self.feed.log)
        self.counters0 = self._counters()

    def _close_window(self) -> None:
        if self.end_batch is None:
            self.end_batch = len(self.feed.log)
            self.counters1 = self._counters()
            self.phase = "profile" if self.trace else ("ended" if self.backlog else "drain")

    def pop(self):
        t_a = time.perf_counter()
        with torch.profiler.record_function("portbench:pop"):
            b = self._pop(t_a)
        if b is None:
            return self._empty
        self.pops.append((t_a, time.perf_counter()))
        return b

    def _pop(self, now: float):
        if self.backlog:
            if self.phase == "warmup" and len(self.feed.log) >= self.warm_batches \
                    and self.summaries:
                self._open_window(now)
            if self.phase == "window" and now >= self.t_end:
                self._close_window()
            if self.phase == "profile":
                self._profile_tick(now)
            if self.phase == "ended":
                self.ctx.cancel()
                return None
            return self.feed.next_batch()
        # open loop: ready batches until the kernels are built and a
        # harvest has run, then the schedule; its first `warmup_s`
        # seconds are still set-up
        f = self.feed
        if self.phase == "warmup" and not f.t0:
            if len(f.log) < self.warm_batches or not self.summaries:
                return f.ready_batch()
            f.start(now)
            w0 = float(self.traffic["warmup_s"])
            self.sched_t0 = now + w0
            self.window_chunks = int(np.searchsorted(f.offsets, w0 + self.seconds,
                                                     side="right"))
            f.limit = int(np.searchsorted(f.offsets, w0 + self.seconds + self._after_s(),
                                          side="right"))
        if self.phase == "warmup" and now >= self.sched_t0:
            self._open_window(self.sched_t0)
        if self.phase == "window" and now >= self.t_end:
            self._close_window()
        if self.phase == "profile":
            # the slice starts once every chunk of the window is popped
            popped = (f.queue[0] if f.queue else f.next_due) >= self.window_chunks
            self._profile_tick(now, popped or now >= self.t_end + PROF_LEAD_S)
        if self.phase == "drain":
            f._advance(now)
            if (not f.queue and f.next_due >= f.limit) or \
                    now >= self.t_end + float(self.traffic["drain_max_s"]):
                self.ctx.cancel()
                return None
        return f.next_batch()

    def _after_s(self) -> float:
        """Seconds of schedule offered after the window: a traced run's
        slice and its lead."""
        return self.prof_span + PROF_LEAD_S if self.trace else 0.0

    # -- the run's hooks --------------------------------------------------------------

    def on_summary(self, s) -> None:
        rec = {"t": time.perf_counter(), "covers": len(self.feed.log), "phase": self.phase,
               "events": s.events, "drops": s.drops, "distinct": float(s.distinct),
               "entropy_bits": float(s.entropy_bits),
               "heavy_hitters": [(int(k), int(c)) for k, c in s.heavy_hitters],
               "approx": bool(s.approx), "decoded": [(int(k), int(c)) for k, c in s.decoded]}
        if s.quantiles is not None:
            q = s.quantiles
            rec["quantiles"] = [q["p50"], q["p90"], q["p99"], q["p999"]]
        self.summaries.append(rec)

    def on_sealed(self, info: dict) -> None:
        self.seals.append({"t": time.perf_counter(), "covers": len(self.feed.log),
                           "phase": self.phase, "window": int(info["window"])})

    def on_answer(self, header: dict, payload: bytes) -> None:
        """A standing query's published answer: one merged window."""
        from inspektor_gadget_tpu_torch.history.query import unpack_frames
        from inspektor_gadget_tpu_torch.history.window import decode_window
        (frame,), _ = unpack_frames(payload)
        w = decode_window(*frame)
        self.answers.append({"covers": len(self.feed.log), "id": header["id"],
                             "windows": int(header["windows"]), "events": int(w.events),
                             "drops": int(w.drops), "cms": np.asarray(w.cms, np.int64),
                             "hll": np.asarray(w.hll, np.int64),
                             "ent": np.asarray(w.ent, np.float64)})

    def on_batch(self, batch) -> None:
        t = time.perf_counter()
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.done.append((t, ev))
        if self.inst is None:
            from inspektor_gadget_tpu_torch.operators.tpusketch import live_instances
            self.inst = next(i for i in live_instances() if i.ctx.run_id == self.ctx.run_id)
        if len(self.summaries) > self._seen_summaries:
            self._seen_summaries = len(self.summaries)
            self.harvest_ms.append(dict(self.inst.last_harvest_ms, phase=self.phase))
        if len(self.seals) > self._seen_seals:
            self._seen_seals = len(self.seals)
            self.seal_ms.append(dict(self.inst.last_seal_ms, phase=self.phase))

    # -- the run ---------------------------------------------------------------------

    def _context(self, hist_dir: str | None):
        from inspektor_gadget_tpu_torch.gadgets import registry
        from inspektor_gadget_tpu_torch.gadgets.context import GadgetContext
        from inspektor_gadget_tpu_torch.operators import operators as ops
        from inspektor_gadget_tpu_torch.params import Collection
        cat, name = self.cfg["gadget"].split("/")
        real = registry.get(cat, name)
        source = _FeedSource(self)

        def make_gadget(ctx):
            g = real.new_instance(ctx)

            def make_source():
                g._threaded = True
                return source
            g._make_source = make_source
            if self.trace:
                wrap_handler(g)
            return g

        desc = type("BenchDesc", (type(real),), {"new_instance": lambda _s, ctx: make_gadget(ctx)})()
        gp = desc.params().to_params()
        gp.set("batch-size", str(self.batch_size))
        op_params = Collection()
        for op in ops.get_all():
            op_params[f"operator.{op.name}."] = op.instance_params().to_params()
        sp = op_params["operator.tpusketch."]
        for k, v in self.cfg["operator"].items():
            sp.set(k, str(v))
        sp.set("enable", "true")
        if hist_dir is not None:
            sp.set("history-dir", hist_dir)
        extra = {"on_sketch_summary": self.on_summary, "on_window_sealed": self.on_sealed,
                 "on_query_answer": self.on_answer}
        return GadgetContext(desc, gadget_params=gp, operator_params=op_params, extra=extra,
                             device=str(self.dev))

    def execute(self) -> dict:
        import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401 (registers gadgets, operators)
        from inspektor_gadget_tpu_torch.runtime.local import LocalRuntime
        from inspektor_gadget_tpu_torch.sources.batch import EventBatch
        t = self.traffic
        self.backlog = t["kind"] == "backlog"
        stream = self.cfg["stream"]
        if self.backlog:
            self.batch_size = int(t["batch_events"])
            self.warm_batches = int(t["warmup_min_batches"])
            pool = EventPool.make(stream, self.seed, self.batch_size * int(t["pool_batches"]))
            self.feed = BacklogFeed(pool, self.batch_size, EventBatch)
        else:
            self.batch_size = int(t["pop_max_events"])
            self.warm_batches = int(t["warmup_min_batches"])
            pool = EventPool.make(stream, self.seed, int(t["pool_events"]))
            self.feed = OpenLoopFeed(
                pool, chunk=int(t["chunk_events"]), rate=float(t["rate_events_per_s"]),
                pop_max=self.batch_size, queue_max=int(t["queue_max_events"]),
                horizon_s=float(t["warmup_s"]) + self.seconds + self._after_s(),
                seed=self.seed,
                batch_cls=EventBatch)
        self.pool = pool
        order = np.argsort(pool.vocab_hashes)
        self._sorted_hashes, self._hash_order = pool.vocab_hashes[order], order
        self._empty = EventBatch.alloc(1, with_comm=False)
        hist_dir = (tempfile.mkdtemp(prefix="portbench-history-")
                    if self.cfg["operator"].get("history") == "true" else None)
        try:
            return self._execute(LocalRuntime, hist_dir)
        finally:
            if hist_dir is not None:
                shutil.rmtree(hist_dir, ignore_errors=True)

    def _execute(self, runtime_cls, hist_dir: str | None) -> dict:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
            torch.cuda.synchronize()
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            anchor.synchronize()
            t_anchor = time.perf_counter()
        if self.trace and self.cuda:
            _warm_profiler()
        self.ctx = self._context(hist_dir)
        out = runtime_cls().run_gadget(self.ctx, on_batch=self.on_batch)
        self._stop_profile()
        err = out["local"].error
        if err:
            raise RuntimeError(f"the gadget run failed: {err}")
        self._close_window()
        done_t = [t for t, _ in self.done]
        if self.cuda:
            torch.cuda.synchronize()
            done_t = [t_anchor + anchor.elapsed_time(ev) / 1e3 for _, ev in self.done]
        peak = torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0
        prog = self._program_outputs(hist_dir)
        self.inst = None
        self.ctx = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        obs = self._observations(done_t)
        if self.prof is not None:
            obs["profile"] = devtrace.reduce(self.prof.events(), self.prof_t[1] - self.prof_t[0])
            self.prof = None
        return {"prog": prog, "obs": obs, "peak": peak}

    def judge(self, prog: dict, *, control: bool = False) -> dict:
        """The reference's outputs for this run's batches (the control's
        with `control`)."""
        t = time.perf_counter()
        try:
            return self._judge(control)
        finally:
            self.reference_s = time.perf_counter() - t

    def _judge(self, control: bool) -> dict:
        return check.reference_outputs(
            self.cfg, self.pool, self.feed.log, [s["covers"] for s in self.summaries],
            [s["covers"] for s in self.seals], self.dev, control=control,
            decoded=[s["decoded"] for s in self.summaries])

    # -- what the run produced --------------------------------------------------------

    def _program_outputs(self, hist_dir: str | None) -> dict:
        b = self.inst.bundle

        def a(t):
            return t.detach().cpu().numpy()

        leaves = {"cms.table": a(b.cms.table).astype(np.int64),
                  "cms.total": np.array([float(b.cms.total)]),
                  "hll.registers": a(b.hll.registers).astype(np.int64),
                  "entropy.counts": a(b.entropy.counts).astype(np.float64),
                  "topk.keys": a(b.topk.keys).astype(np.int64) & 0xFFFFFFFF,
                  "topk.counts": a(b.topk.counts).astype(np.int64),
                  "topk.overflow": np.array([int(b.topk.overflow)]),
                  "events": np.array([float(b.events)]), "drops": np.array([float(b.drops)])}
        if b.inv is not None:
            leaves["inv.count"] = a(b.inv.count).astype(np.int64)
            leaves["inv.keysum"] = a(b.inv.keysum).astype(np.int64) & 0xFFFFFFFF
            leaves["inv.fpsum"] = a(b.inv.fpsum).astype(np.int64) & 0xFFFFFFFF
        qt = None
        if b.quantiles is not None:
            leaves["qt.zeros"] = np.array([int(b.quantiles.zeros)])
            leaves["qt.total"] = np.array([int(b.quantiles.total)])
            qt = a(b.quantiles.counts).astype(np.int64)
        out = {"leaves": leaves, "summaries": self.summaries, "qt_counts": qt, "windows": [],
               "answers": self.answers, "seal_marks": self.seals}
        if hist_dir is not None:
            out["windows"] = _read_windows(hist_dir)
        return out

    def _observations(self, done_t: list[float]) -> dict:
        """Everything the metric readers read, for the window's batches
        [first_window_batch, end_batch)."""
        lo, hi = self.first_window_batch or 0, self.end_batch or 0
        log = self.feed.log
        batches = [{"n": log.counts[i], "pop_start": self.pops[i][0],
                    "pop_end": self.pops[i][1], "handled": self.done[i][0],
                    "done": done_t[i]} for i in range(lo, hi)]
        c0, c1 = self.counters0 or {}, self.counters1 or {}
        counters = {k: (c1[k][0] - c0[k][0], c1[k][1] - c0[k][1]) for k in c0}
        obs = {"kind": "backlog" if self.backlog else "open_loop", "seconds": self.seconds,
               "t0": self.t0, "t_end": self.t_end, "setup_s": self._setup_s(),
               "batches": batches, "counters": counters,
               "harvests": [h for h in self.harvest_ms if h["phase"] == "window"],
               "seals": [h for h in self.seal_ms if h["phase"] == "window"],
               "k2_least_ms": roofline.k2_least_ms(self.cfg["operator"],
                                                   _pad(self.batch_size))}
        # a summary's newest batch: its due time (open loop) or its pop
        lag = []
        for s in self.summaries:
            if s["phase"] != "window" or s["covers"] == 0:
                continue
            i = s["covers"] - 1
            due = self.pops[i][0] if self.backlog else self._batch_due(i)
            lag.append(s["t"] - due)
        obs["summary_lag_s"] = lag
        if not self.backlog:
            f = self.feed
            w0 = float(self.traffic["warmup_s"])
            win = np.flatnonzero((f.offsets >= w0) & (f.offsets <= w0 + self.seconds))
            win = win[win < f.limit]
            due = f.t0 + f.offsets[win]
            bidx = f.batch_of[win]
            fin = np.array([done_t[j] if j >= 0 else math.inf for j in bidx])
            obs["chunks"] = {"due": due, "pop": f.pop_t[win], "done": fin,
                             "dropped": int(np.sum(bidx < 0))}
            obs["queue_depth"] = [(t, d) for t, d in f.depth_at_pop
                                  if self.t0 <= t <= self.t_end]
        return obs

    def _batch_due(self, i: int) -> float:
        f = self.feed
        last_chunk = (f.log.starts[i] + f.log.counts[i]) // f.chunk - 1 - f.base
        return f.t0 + float(f.offsets[last_chunk])

    def _setup_s(self) -> float:
        i = self.first_window_batch
        if i is None or i >= len(self.pops):
            return math.nan
        return self.pops[i][0] - self.t_proc0

    def attempted_failed(self, obs: dict) -> tuple[int, int]:
        if self.backlog:
            return len(obs["batches"]), 0
        return len(obs["chunks"]["due"]), obs["chunks"]["dropped"]


def _warm_profiler() -> None:
    """Set-up: one short trace, so the profiler's own start-up (CUPTI's)
    is paid before the window, not inside its slice."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def wrap_handler(gadget) -> None:
    """Name the gadget's batch handler (the operator chain and the
    callback) on the profiler's timeline: ``portbench:handler``."""
    set_handler = gadget.set_batch_handler

    def set_named(handler):
        def named(batch):
            with torch.profiler.record_function("portbench:handler"):
                handler(batch)
        set_handler(named)
    gadget.set_batch_handler = set_named


def _pad(n: int) -> int:
    """The operator's device batch shape for a gadget batch size of n."""
    return max(8192, 1 << (n - 1).bit_length())


def _read_windows(hist_dir: str) -> list[dict]:
    """Every window the run sealed into its store, oldest first."""
    from inspektor_gadget_tpu_torch.history import HISTORY
    from inspektor_gadget_tpu_torch.history.window import decode_window
    wins = [decode_window(h, p) for h, p in HISTORY.fetch_windows(base_dir=hist_dir)]
    wins.sort(key=lambda w: w.window)
    out = []
    for w in wins:
        d = {"events": int(w.events), "drops": int(w.drops),
             "cms": np.asarray(w.cms, np.int64), "hll": np.asarray(w.hll, np.int64),
             "ent": np.asarray(w.ent, np.float64),
             "topk_keys": np.asarray(w.topk_keys, np.int64),
             "topk_counts": np.asarray(w.topk_counts, np.int64),
             "slices": {k: {"events": int(s["events"]), "hll": np.asarray(s["hll"], np.int64),
                            "ent": np.asarray(s["ent"], np.int64),
                            "hh": [(int(a), int(b)) for a, b in s["hh"]]}
                        for k, s in w.slices.items()},
             "slices_dropped": int(w.slices_dropped),
             "qt_zeros": int(w.qt_zeros), "qt_total": int(w.qt_total)}
        for f in ("inv_count", "inv_keysum", "inv_fpsum", "rs_keys", "rs_weights"):
            v = getattr(w, f)
            if v is not None:
                d[f] = np.asarray(v, np.int64)
        out.append(d)
    return out
