"""The port's trace gadget family and the snapshot pair against the JAX
package's, on the CPU.

The registries hold the same trace and snapshot gadgets with the same
catalog entries. Each of the twelve trace gadgets runs through each
package's `LocalRuntime` on the pysynthetic source (seed 7, 3 batches
of 1024) with the sketch plane off, and the rows agree as JSON, the
wall-clock timestamp and the identity columns (named by each package's
localmanager from its own procfs scan) aside. open, tcp and dns run
again with the sketch plane on at a small geometry (invertible and
quantile planes): the final summaries agree, estimates bit for bit.
Each decoder's branch for a real capture is held to the reference's on
hand-built EventBatches. An explicit synthetic run never builds the
native library; ``--source native`` raises where it is missing, and
``--source auto`` picks the pysynthetic source there.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import gadgets as RG
from inspektor_gadget_tpu import params as RPm
from inspektor_gadget_tpu.operators import operators as ROps
from inspektor_gadget_tpu.runtime.local import LocalRuntime as RefLocalRuntime
from inspektor_gadget_tpu.runtime.runtime import build_catalog as ref_catalog
from inspektor_gadget_tpu.sources import batch as RB
from inspektor_gadget_tpu_torch import gadgets as PG
from inspektor_gadget_tpu_torch import params as PPm
from inspektor_gadget_tpu_torch.operators import operators as POps
from inspektor_gadget_tpu_torch.ops import kernels as K
from inspektor_gadget_tpu_torch.runtime import LocalRuntime
from inspektor_gadget_tpu_torch.runtime.runtime import build_catalog
from inspektor_gadget_tpu_torch.sources import batch as PB
from inspektor_gadget_tpu_torch.sources import bridge

torch.set_num_threads(2)

TRACE = ("bind", "capabilities", "dns", "fsslower", "mount", "network", "oomkill", "open",
         "signal", "sni", "tcp", "tcpconnect")
SNAPSHOT = ("process", "socket")
SMALL = {"depth": "3", "log2-width": "10", "hll-p": "8", "entropy-log2-width": "6",
         "topk": "8", "harvest-interval": "1h", "invertible": "true",
         "inv-log2-buckets": "9", "quantiles": "true"}
BATCHES, BATCH = 3, 1024
IDENTITY = ("timestamp", "node", "namespace", "pod", "container")


class _Run:
    """One package's LocalRuntime run of a trace gadget on pysynthetic,
    cancelled from the batch callback after `batches` batches."""

    def __init__(self, port: bool, name: str, sketch: bool = False, batches: int = BATCHES):
        G, Pm, Ops = (PG, PPm, POps) if port else (RG, RPm, ROps)
        desc = G.get("trace", name)
        gp = desc.params().to_params()
        for k, v in {"source": "pysynthetic", "seed": "7", "batch-size": str(BATCH),
                     "rate": "1e9"}.items():
            gp.set(k, v)
        sp = Ops.get("tpusketch").instance_params().to_params()
        if sketch:
            for k, v in {"enable": "true", **SMALL}.items():
                sp.set(k, v)
        self.summaries: list = []
        self.rows: list = []
        kw = {"device": "cpu"} if port else {}
        self.ctx = G.GadgetContext(desc, gadget_params=gp,
                                   operator_params=Pm.Collection({"operator.tpusketch.": sp}),
                                   extra={"on_sketch_summary": self.summaries.append}, **kw)
        self.batches = 0
        self.events = 0

        def batch_cb(batch):
            self.batches += 1
            self.events += batch.count
            if self.batches == batches:
                self.ctx.cancel()

        runtime = LocalRuntime() if port else RefLocalRuntime()
        out = runtime.run_gadget(self.ctx, on_event=self.rows.append, on_batch=batch_cb)
        self.result = out["local"]

    def json_rows(self) -> list[dict]:
        out = []
        for ev in self.rows:
            d = json.loads(self.ctx.columns.to_json(ev))
            for k in IDENTITY:
                d.pop(k, None)
            out.append(d)
        return out


def _gadget_entries(catalog: dict) -> list[dict]:
    keep = {("trace", n) for n in TRACE} | {("snapshot", n) for n in SNAPSHOT}
    return [g for g in catalog["gadgets"] if (g["category"], g["name"]) in keep]


def test_registry_and_catalog_match_the_reference():
    want = _gadget_entries(ref_catalog())
    got = _gadget_entries(build_catalog())
    assert [(g["category"], g["name"]) for g in got] == \
        [(g["category"], g["name"]) for g in want]
    assert len(got) == len(TRACE) + len(SNAPSHOT)
    assert got == want
    port_names = [(d.category, d.name) for d in PG.registry.get_all()]
    assert [(c, n) for c, n in port_names if c in ("trace", "snapshot")] == \
        sorted([("snapshot", n) for n in SNAPSHOT] + [("trace", n) for n in TRACE + ("exec",)])


@pytest.mark.parametrize("name", TRACE)
def test_rows_match_the_reference(name):
    ref, port = _Run(False, name), _Run(True, name)
    assert ref.result.error is None and port.result.error is None, port.result.error
    assert port.batches == ref.batches == BATCHES
    want, got = ref.json_rows(), port.json_rows()
    assert len(got) == len(want) == BATCHES * BATCH
    assert list(got[0]) == list(want[0])
    assert got == want


def _assert_summaries_equal(got, want) -> None:
    """Every field but the pipeline block: the estimates bit for bit,
    the accuracy block to 1e-4, the rest exactly."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    for d in (g, w):
        d.pop("pipeline")
    ga, wa = g.pop("accuracy"), w.pop("accuracy")
    assert (ga is None) == (wa is None)
    for k in (wa or {}):
        if isinstance(wa[k], float):
            assert np.isclose(ga[k], wa[k], rtol=1e-4, atol=1e-7), k
        else:
            assert ga[k] == wa[k], k
    assert g == w


@pytest.mark.parametrize("name", ("open", "tcp", "dns"))
def test_sketch_summary_matches_the_reference(name, monkeypatch):
    plain = []
    monkeypatch.setattr(K, "fused_planes_plain",
                        lambda *a, _f=K.fused_planes_plain: plain.append(1) or _f(*a))
    launches = K.fused_planes.launches
    ref, port = _Run(False, name, sketch=True), _Run(True, name, sketch=True)
    assert ref.result.error is None and port.result.error is None, port.result.error
    assert ref.summaries and port.summaries
    got, want = port.summaries[-1], ref.summaries[-1]
    assert got.events == want.events == port.events == BATCHES * BATCH
    assert got.distinct == want.distinct and got.entropy_bits == want.entropy_bits
    _assert_summaries_equal(got, want)
    # K2's plain version once a batch on the CPU, the kernel never
    assert len(plain) == BATCHES and K.fused_planes.launches == launches


# -- the decoders' real-capture branches -------------------------------------

def _ip4(s: str) -> int:
    return struct.unpack("<I", bytes(int(x) for x in s.split(".")))[0]


VOCAB = {101: "/etc/hostname", 102: "tmpfs\x1f/mnt/x\x1ftmpfs", 103: "ig_victim",
         104: "fe80::1\x1f2001:db8::2", 105: "127.0.0.1:48712", 106: "example.com",
         107: "10.0.0.7", 108: "bash"}
V6 = 1 << 48

# (gadget, native source, rows: each a dict of wire columns)
DECODE_CASES = [
    ("tcp", False, [
        {"kind": 4, "aux1": (_ip4("10.1.2.3") << 32) | _ip4("192.168.0.9"),
         "aux2": (40000 << 16) | 443},
        {"kind": 5, "aux1": 104, "aux2": V6 | (8080 << 16) | 51000},
        {"kind": 6, "aux1": (_ip4("127.0.0.1") << 32) | _ip4("127.0.0.1"),
         "aux2": (7 << 32) | (5432 << 16) | 40001},   # /proc state 7 in bits 32-35
        {"kind": 4, "aux1": 104, "aux2": V6 | (10 << 32) | (1 << 16) | 2},
    ]),
    ("tcpconnect", False, [
        {"kind": 4, "aux1": (_ip4("8.8.8.8") << 32) | _ip4("1.1.1.1"), "aux2": 53}]),
    ("oomkill", False, [
        {"kind": 11, "pid": 31337, "key_hash": 103, "aux1": 51200, "aux2": 108}]),
    ("capabilities", False, [
        {"kind": 12, "aux1": 1, "aux2": 0},     # CHOWN allowed
        {"kind": 12, "aux1": 0, "aux2": 5},     # KILL denied
        {"kind": 12, "aux1": 0, "aux2": 21},    # SYS_ADMIN denied
        {"kind": 12, "aux1": 1, "aux2": 77},    # past the table
    ]),
    ("signal", False, [
        {"kind": 9, "pid": 10, "ppid": 20, "aux1": 2, "aux2": 15},   # sender side
        {"kind": 9, "pid": 20, "ppid": 20, "aux1": 0, "aux2": 15},   # delivery
        {"kind": 9, "pid": 30, "aux1": 1, "aux2": 10},               # fatal
        {"kind": 9, "pid": 30, "aux1": 7, "aux2": 33},               # unknown origin, signal
    ]),
    ("open", False, [
        {"kind": 3, "aux1": 101, "aux2": 2}, {"kind": 3, "aux1": 101, "aux2": 1}]),
    ("mount", False, [
        {"kind": 10, "key_hash": 102, "aux2": 0}, {"kind": 10, "key_hash": 102, "aux2": 1}]),
    ("bind", False, [
        {"kind": 8, "aux1": 105, "aux2": (6 << 16) | 48712},
        {"kind": 8, "aux1": 105, "aux2": (1 << 24) | (17 << 16) | 48713}]),
    ("fsslower", False, [
        {"kind": 13, "key_hash": 101, "aux1": 1234, "aux2": (3 << 32) | 4096},
        {"kind": 13, "key_hash": 101, "aux1": 7, "aux2": (9 << 32) | 1}]),
    ("dns", True, [
        {"kind": 7, "key_hash": 106, "aux2": ((28 << 16) << 32)},
        {"kind": 7, "key_hash": 106, "aux2": (((1 << 16) | 0x80 | 3) << 32)}]),
    ("network", True, [
        {"kind": 7, "key_hash": 107, "aux2": (17 << 32) | 53},
        {"kind": 7, "key_hash": 0, "aux1": 9, "aux2": (99 << 32) | 80}]),
    ("sni", True, [{"kind": 7, "key_hash": 106}]),
]


class _Vocab:
    """A capture's vocab side-table, the same for both packages."""

    def vocab_lookup(self, key: int) -> str:
        return VOCAB.get(int(key), "")


def _decoded(G, Pm, Batch, name: str, native: bool, rows: list[dict], port: bool) -> list[dict]:
    desc = G.get("trace", name)
    gp = desc.params().to_params()
    gp.set("source", "pysynthetic")
    kw = {"device": "cpu"} if port else {}
    ctx = G.GadgetContext(desc, gadget_params=gp, **kw)
    g = desc.new_instance(ctx)
    g.source = g._current_source = _Vocab()
    g._is_native = native
    b = Batch.alloc(len(rows))
    b.count = len(rows)
    for i, r in enumerate(rows):
        for k, v in {"ts": 1000 + i, "mntns": 4026531840, "pid": 7, **r}.items():
            b.cols[k][i] = v
        b.comm[i, :4] = np.frombuffer(b"sh\0\0", np.uint8)
    return [dataclasses.asdict(g.decode_row(b, i)) for i in range(b.count)]


@pytest.mark.parametrize("name,native,rows", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_row_matches_the_reference(name, native, rows):
    want = _decoded(RG, RPm, RB.EventBatch, name, native, rows, port=False)
    got = _decoded(PG, PPm, PB.EventBatch, name, native, rows, port=True)
    assert got == want
    if name == "tcp":
        assert [r["ipversion"] for r in got] == [4, 6, 4, 6]
        assert got[1]["saddr"] == "fe80::1" and got[2]["sport"] == 5432
    if name == "signal":
        assert [r["origin"] for r in got[:3]] == ["sent", "deliver", "fatal"]
        assert got[0]["tpid"] == 20
    if name == "capabilities":
        assert [(r["cap"], r["verdict"]) for r in got] == \
            [("CHOWN", "allow"), ("KILL", "deny"), ("SYS_ADMIN", "deny"), ("77", "allow")]
    if name == "oomkill":
        assert got[0]["kcomm"] == "bash" and got[0]["pages"] == 51200


# -- the native library is built only where a run asks for it ---------------

def _refuse_library(monkeypatch) -> list:
    asked = []

    def refuse():
        asked.append(1)
        raise RuntimeError("native capture library refused by the test")

    monkeypatch.setattr(bridge.LIBRARY, "get", refuse)
    return asked


@pytest.mark.parametrize("mode", ("pysynthetic", "synthetic"))
def test_explicit_synthetic_runs_never_build_the_library(mode, monkeypatch):
    asked = _refuse_library(monkeypatch)
    for name in TRACE:
        desc = PG.get("trace", name)
        gp = desc.params().to_params()
        gp.set("source", mode)
        ctx = PG.GadgetContext(desc, gadget_params=gp, device="cpu")
        desc.new_instance(ctx)
    assert not asked
    run = _Run(True, "tcp", batches=1)
    assert run.result.error is None and len(run.rows) == BATCH
    assert not asked


def test_native_raises_and_auto_picks_pysynthetic_without_the_library(monkeypatch):
    asked = _refuse_library(monkeypatch)
    monkeypatch.setattr(bridge, "_unavailable", None)
    for name in ("tcp", "signal", "capabilities", "fsslower"):
        desc = PG.get("trace", name)
        gp = desc.params().to_params()
        gp.set("source", "native")
        with pytest.raises(RuntimeError, match="refused by the test"):
            desc.new_instance(PG.GadgetContext(desc, gadget_params=gp, device="cpu"))
    desc = PG.get("trace", "tcp")
    gp = desc.params().to_params()
    for k, v in {"source": "auto", "batch-size": "256", "rate": "1e9"}.items():
        gp.set(k, v)
    ctx = PG.GadgetContext(desc, gadget_params=gp, device="cpu")
    g = desc.new_instance(ctx)
    assert g.native_kind == bridge.SRC_PROC_TCP
    src = g._make_source()
    assert type(src).__name__ == "PySyntheticSource" and not g._is_native
    assert asked
