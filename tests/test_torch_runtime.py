"""The port's gadget framework end to end on the CPU: `LocalRuntime` runs
``trace/exec`` on the pysynthetic source (seed 7, batches of 4096),
cancelled from the batch callback after 6 batches, in both packages.

With the sketch plane off, both runs give the same rows (all fields but
the wall-clock timestamp), their identity columns filled by each
package's localmanager operator from the same seeded collection. With
it on (invertible, quantiles, the audit plane and the ae scorer, at the
small geometry of
``tests/test_torch_operator.py``), the final `SketchSummary`s agree to
that file's tolerances, the port's tracer records the run span with the
reference's ``tpusketch/*`` children, and ``top/sketch`` reads the live
instance during the run and nothing after it. With the history plane on,
each package's run seals into its own store the same windows, and
``top/windows`` lists the port's. Parameters the port does not run yet
become the node's error, naming their ROADMAP item, as do the
reference's cross-param errors.
"""

from __future__ import annotations

from collections import Counter

import jax
import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu.history import HISTORY as REF_HISTORY
from inspektor_gadget_tpu import gadgets as RG
from inspektor_gadget_tpu import params as RPm
from inspektor_gadget_tpu.operators import operators as ROps
from inspektor_gadget_tpu.operators import tpusketch as R
from inspektor_gadget_tpu.runtime.local import LocalRuntime as RefLocalRuntime
from inspektor_gadget_tpu.telemetry.tracing import TRACER as REF_TRACER
from inspektor_gadget_tpu_torch import gadgets as PG
from inspektor_gadget_tpu_torch import params as PPm
from inspektor_gadget_tpu_torch.gadgets.top import sketch as top_sketch
from inspektor_gadget_tpu_torch.history import HISTORY, decode_window
from inspektor_gadget_tpu_torch.models.params import params_from_numpy
from inspektor_gadget_tpu_torch.operators import operators as POps
from inspektor_gadget_tpu_torch.operators import tpusketch as P
from inspektor_gadget_tpu_torch.runtime import LocalRuntime
from inspektor_gadget_tpu_torch.telemetry.tracing import TRACER

torch.set_num_threads(2)

SMALL = {"depth": "3", "log2-width": "10", "hll-p": "8", "entropy-log2-width": "6",
         "topk": "8", "harvest-interval": "1h"}
PLANES = {"invertible": "true", "inv-log2-buckets": "9", "quantiles": "true",
          "audit-sample": "64", "anomaly": "true", "anomaly-model": "ae"}
BATCHES = 6
BATCH = 4096
RTOL = 1e-4
IDENTITY = ("node", "namespace", "pod", "container")  # the reference's localmanager's


class _Run:
    """One package's LocalRuntime run of trace/exec."""

    def __init__(self, port: bool, sketch: dict | None, rows: bool = False,
                 on_batch=None, batches: int = BATCHES, extra: dict | None = None):
        G, Pm, Ops = (PG, PPm, POps) if port else (RG, RPm, ROps)
        desc = G.get("trace", "exec")
        gp = desc.params().to_params()
        for k, v in {"source": "pysynthetic", "seed": "7", "batch-size": str(BATCH),
                     "rate": "1e9"}.items():
            gp.set(k, v)
        sp = Ops.get("tpusketch").instance_params().to_params()
        if sketch is not None:
            for k, v in {"enable": "true", **SMALL, **sketch}.items():
                sp.set(k, v)
        self.summaries: list = []
        self.rows: list = []
        kw = {"device": "cpu"} if port else {}
        self.ctx = G.GadgetContext(desc, gadget_params=gp,
                                   operator_params=Pm.Collection({"operator.tpusketch.": sp}),
                                   extra={"on_sketch_summary": self.summaries.append,
                                          **(extra or {})}, **kw)
        self.batches = 0

        def batch_cb(batch):
            self.batches += 1
            if on_batch is not None:
                on_batch(self)
            if self.batches == batches:
                self.ctx.cancel()

        runtime = LocalRuntime() if port else RefLocalRuntime()
        out = runtime.run_gadget(self.ctx, on_event=self.rows.append if rows else None,
                                 on_batch=batch_cb)
        self.result = out["local"]


def _close(got, want, what: str) -> None:
    """Recursive equality: floats to RTOL, everything else exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert np.isclose(got, want, rtol=RTOL, atol=1e-7), f"{what}: {got} != {want}"
    else:
        assert got == want, f"{what}: {got!r} != {want!r}"


def _assert_summaries_equal(got, want) -> None:
    """The summaries to ``tests/test_torch_operator.py``'s tolerances,
    the pipeline block (wall-clock watermarks) aside."""
    assert got.events == want.events and got.drops == want.drops
    assert np.isclose(got.distinct, want.distinct, rtol=RTOL, atol=0)
    assert np.isclose(got.entropy_bits, want.entropy_bits, rtol=RTOL, atol=0)
    for field in ("heavy_hitters", "epoch", "names", "approx", "decoded", "decoded_only",
                  "inv", "classes", "quantiles"):
        assert getattr(got, field) == getattr(want, field), field
    _close(got.accuracy, want.accuracy, "accuracy")
    if want.anomaly is None:
        assert got.anomaly is None
        return
    assert list(got.anomaly) == list(want.anomaly)
    g = np.array(list(got.anomaly.values()))
    w = np.array(list(want.anomaly.values()))
    assert (np.abs(g - w) <= 5e-2 * np.abs(w)).all(), (g, w)


@pytest.fixture(scope="module")
def sketch_runs():
    """The reference's and the port's runs with every plane on; the
    reference's initial scorer weights are carried into the port's
    instance at its first batch (the scorer trains only at the harvest),
    and top/sketch is read after the third batch."""
    carried: dict = {}

    def ref_first(run):
        if run.batches == 1:
            inst = R._live[run.ctx.run_id]
            carried["params"] = jax.tree.map(np.array, inst.scorer.params)

    ref = _Run(False, PLANES, on_batch=ref_first)
    seen: dict = {}

    def port_hook(run):
        if run.batches == 1:
            params_from_numpy(P._live[run.ctx.run_id].scorer, carried["params"])
        if run.batches == 3:
            src = {s.run_id: s for s in top_sketch.live_sources()}[run.ctx.run_id]
            seen["source"] = (src.steps, src.events, src.drops, src.gadget)
            tctx = PG.GadgetContext(PG.get("top", "sketch"))
            top = tctx.desc.new_instance(tctx)
            top.setup(tctx)
            seen["rows"] = [r for r in top.collect(tctx) if r.runid == run.ctx.run_id]

    port = _Run(True, PLANES, on_batch=port_hook)
    return ref, port, seen


@pytest.fixture()
def seeded_fleet():
    """Both packages' localmanager collections seeded with the same 64
    containers, one for each synthetic mount namespace (so the identity
    columns do not depend on which processes a procfs scan saw); they
    and their removal-grace entries are removed afterwards."""
    from inspektor_gadget_tpu.containers import Container as RefContainer
    from inspektor_gadget_tpu_torch.containers import Container

    def fleet(cls) -> list:
        return [cls(id=f"rt-{k:02d}", name=f"ctr-{k:02d}", pod=f"pod-{k // 2:02d}",
                    namespace=f"team-{'abcd'[k % 4]}", mntns=4026531840 + k)
                for k in range(64)]

    seeded = []
    for Ops, cls in ((ROps, RefContainer), (POps, Container)):
        lm = Ops.get("localmanager")
        with Ops._init_lock:
            if "localmanager" not in Ops._initialized:
                gp = lm.global_params().to_params()
                gp.set("containerd-like-discovery", "none")
                lm.init(gp)
                Ops._initialized.add("localmanager")
        for c in fleet(cls):
            lm.cc.add_container(c)
        seeded.append((lm.cc, fleet(cls)))
    yield
    for cc, cs in seeded:
        for c in cs:
            cc.remove_container(c.id)
            with cc._mu:
                cc._removed.pop(c.mntns, None)


def test_rows_match_the_reference_with_the_sketch_plane_off(seeded_fleet):
    ref, port = _Run(False, None, rows=True), _Run(True, None, rows=True)
    assert ref.result.error is None and port.result.error is None, port.result.error
    assert port.batches == ref.batches == BATCHES
    assert len(port.rows) == len(ref.rows) == BATCHES * BATCH
    rcols, pcols = ref.ctx.columns, port.ctx.columns
    # both chains run their localmanager operator, which fills the
    # identity columns from the seeded collection: node "local" and the
    # container of each row's mount namespace
    assert {rcols.to_dict(r)["node"] for r in ref.rows} == {"local"}
    for i in range(len(ref.rows)):
        r, p = rcols.to_dict(ref.rows[i]), pcols.to_dict(port.rows[i])
        k = p["mountnsid"] - 4026531840
        assert [p[c] for c in IDENTITY] == ["local", f"team-{'abcd'[k % 4]}",
                                            f"pod-{k // 2:02d}", f"ctr-{k:02d}"]
        r.pop("timestamp")
        p.pop("timestamp")
        assert p == r, i
    assert port.summaries == ref.summaries == []


def test_final_summary_matches_the_reference(sketch_runs):
    ref, port, _ = sketch_runs
    assert ref.result.error is None and port.result.error is None, port.result.error
    assert len(port.summaries) == len(ref.summaries) == 1  # post_gadget_run's harvest
    got, want = port.summaries[-1], ref.summaries[-1]
    assert got.events == BATCHES * BATCH
    assert got.inv is not None and got.quantiles is not None and got.accuracy is not None
    assert got.anomaly and len(got.anomaly) == 64
    _assert_summaries_equal(got, want)


def _run_spans(tracer, run_id: str) -> list[dict]:
    spans = tracer.export()
    run = [s for s in spans if s["name"] == "run/trace/exec"
           and s["attrs"].get("run_id") == run_id]
    assert len(run) == 1
    return [s for s in spans if s["trace_id"] == run[0]["trace_id"]]


def test_tracer_records_the_reference_span_names(sketch_runs):
    ref, port, _ = sketch_runs
    got = _run_spans(TRACER, port.ctx.run_id)
    want = _run_spans(REF_TRACER, ref.ctx.run_id)
    # the port keeps every span of the reference but its per-harvest
    # zero-length pipeline-stage spans, and tiles the batch and the
    # harvest further
    names = Counter(s["name"] for s in got if s["name"].startswith("tpusketch/"))
    ref_names = Counter(s["name"] for s in want if s["name"].startswith("tpusketch/")
                        and not s["name"].startswith("tpusketch/stage/"))
    harvests = ref_names["tpusketch/harvest"]
    assert harvests == 1
    assert names - ref_names == Counter(
        {**dict.fromkeys(("tpusketch/fold", "tpusketch/copy", "tpusketch/post"), BATCHES),
         **{f"tpusketch/harvest/{p}": harvests
            for p in ("dispatch", "wait", "read", "finish", "anomaly")}})
    assert not ref_names - names
    assert names["tpusketch/update"] == names["tpusketch/h2d"] == BATCHES
    by_id = {s["span_id"]: s for s in got}
    for s in got:
        if s["name"] in ("tpusketch/h2d", "tpusketch/update", "tpusketch/post"):
            op = by_id[s["parent_id"]]
            assert op["name"] == "op/tpusketch" and op["attrs"] == {"events": BATCH}
            assert by_id[op["parent_id"]]["name"] == "run/trace/exec"
        if s["name"] in ("tpusketch/h2d", "tpusketch/update"):
            assert s["attrs"]["events"] == BATCH
        if s["name"] in ("tpusketch/fold", "tpusketch/copy"):
            assert by_id[s["parent_id"]]["name"] == "tpusketch/h2d"
        if s["name"].startswith("tpusketch/harvest/"):
            assert by_id[s["parent_id"]]["name"] == "tpusketch/harvest"
        if s["name"] == "tpusketch/harvest":
            assert by_id[s["parent_id"]]["name"] == "run/trace/exec"
            assert s["attrs"] == {"epoch": 1}


def test_top_sketch_reads_the_live_instance(sketch_runs):
    _, port, seen = sketch_runs
    assert seen["source"] == (3, 3 * BATCH, 0, "trace/exec")
    (row,) = seen["rows"]
    assert (row.gadget, row.steps, row.events, row.drops) == ("trace/exec", 3, 3 * BATCH, 0)
    assert port.ctx.run_id not in {s.run_id for s in top_sketch.live_sources()}
    assert port.ctx.run_id not in {i.ctx.run_id for i in P.live_instances()}


@pytest.mark.parametrize("sketch, item", [
    ({"chips": "2"}, "exceeds the 1 local device(s)"),
    ({"shard-ingest": "true"}, "needs >= 2 local devices"),
    ({"standing-queries": '[{"id": "q", "stats": ["topk"], "range": "1m"}]'},
     "needs 'history true'"),
    ({"history": "true", "standing-queries": "[]"}, "no queries defined"),
    ({"query-refresh": "3"}, "needs 'standing-queries'"),
])
def test_unported_params_become_the_node_error(sketch, item):
    run = _Run(True, sketch)
    assert run.result.error is not None and item in run.result.error
    assert run.batches == 0


@pytest.fixture()
def close_writers():
    """Close the history writers both packages' runs opened."""
    opened = {id(h): set(h._writers) for h in (HISTORY, REF_HISTORY)}
    yield
    for h in (HISTORY, REF_HISTORY):
        with h._mu:
            fresh = [h._writers.pop(k) for k in list(h._writers) if k not in opened[id(h)]]
        for w in fresh:
            w.close()


def test_history_run_writes_the_store_and_top_windows_lists_it(tmp_path, monkeypatch,
                                                               close_writers):
    """``history true`` through the framework: each package's run seals
    one window a harvest into its own store, on one injected clock and
    run id; the windows read back are the same, header and arrays, and
    ``top/windows`` lists the port's store ($IG_HISTORY_DIR)."""
    hist = {"history": "true", "history-interval": "0", "harvest-interval": "1h",
            "invertible": "true", "inv-log2-buckets": "9", "quantiles": "true"}
    frames = {}
    for port, h in ((False, REF_HISTORY), (True, HISTORY)):
        base = str(tmp_path / ("port" if port else "ref"))
        tick = iter(range(1, 100))
        extra = {"history_clock": lambda: 1.7e9 + next(tick)}
        run = _Run(port, {**hist, "history-dir": base}, extra=extra)
        assert run.result.error is None, run.result.error
        frames[port] = list(h.fetch_windows(base_dir=base))
    (got,), (want,) = frames[True], frames[False]
    assert got[0] == {**want[0], "run_id": got[0]["run_id"]}
    assert got[0]["events"] == BATCHES * BATCH and got[0]["ts"] == got[0]["end_ts"]
    gw, ww = decode_window(*got), decode_window(*want)
    for name in ("cms", "hll", "ent", "topk_keys", "topk_counts", "inv_count", "qt_counts"):
        a, b = getattr(gw, name), getattr(ww, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert gw.digest == ww.digest
    monkeypatch.setenv("IG_HISTORY_DIR", str(tmp_path / "port"))
    tctx = PG.GadgetContext(PG.get("top", "windows"))
    top = tctx.desc.new_instance(tctx)
    top.setup(tctx)
    (row,) = top.collect(tctx)
    assert (row.gadget, row.window, row.seq, row.events) == ("trace/exec", 1, 1, BATCHES * BATCH)
    assert row.slices == len(got[0]["keys"]) > 0 and row.span_s == 1.0


def test_a_disabled_sketch_plane_needs_no_device():
    """enable=false builds a no-op instance: a cuda context runs on any
    host, and the sketch plane asked for on cuda without a card fails
    with resolve_device's message."""
    desc = PG.get("trace", "exec")
    gp = desc.params().to_params()
    for k, v in {"source": "pysynthetic", "seed": "7", "batch-size": "512"}.items():
        gp.set(k, v)
    ctx = PG.GadgetContext(desc, gadget_params=gp, device="cuda")
    inst = P.TpuSketch().instantiate(ctx, None, P.TpuSketch().instance_params().to_params())
    assert not inst.enabled
    inst.post_gadget_run()
    if not torch.cuda.is_available():
        p = P.TpuSketch().instance_params().to_params()
        p.set("enable", "true")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            P.TpuSketch().instantiate(ctx, None, p)
