"""The port's syscall gadgets (audit seccomp, advise seccomp-profile,
advise network-policy, traceloop) and its copy of the syscall table
against the JAX package's, on the CPU.

Each gadget runs through each package's `LocalRuntime` on the
pysynthetic source (seed 7, 3 batches of 1024, cancelled from the batch
callback): audit seccomp's rows agree as JSON with the wall-clock
timestamp and the identity columns aside, and the result bytes of the
three result gadgets (the OCI profile JSON, the SeccompProfile and
NetworkPolicy YAML, the traceloop table) are equal, exactly. audit
seccomp runs again with the sketch plane on at a small geometry: the
final summaries agree, estimates bit for bit. The decoders' real-capture
branches (ptrace ERRNO, SIGSYS and host-wide audit rows; the ptrace
syscall stream that advise and traceloop fold) are held to the
reference's on hand-built EventBatches, exactly.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import gadgets as RG
from inspektor_gadget_tpu import params as RPm
from inspektor_gadget_tpu.gadgets.advise import network_policy as RNP
from inspektor_gadget_tpu.gadgets.advise import seccomp_profile as RSP
from inspektor_gadget_tpu.operators import operators as ROps
from inspektor_gadget_tpu.runtime.local import LocalRuntime as RefLocalRuntime
from inspektor_gadget_tpu.sources import batch as RB
from inspektor_gadget_tpu.utils import syscalls as RS
from inspektor_gadget_tpu_torch import gadgets as PG
from inspektor_gadget_tpu_torch import params as PPm
from inspektor_gadget_tpu_torch.gadgets.advise import network_policy as PNP
from inspektor_gadget_tpu_torch.gadgets.advise import seccomp_profile as PSP
from inspektor_gadget_tpu_torch.operators import operators as POps
from inspektor_gadget_tpu_torch.ops import kernels as K
from inspektor_gadget_tpu_torch.runtime import LocalRuntime
from inspektor_gadget_tpu_torch.sources import batch as PB
from inspektor_gadget_tpu_torch.sources import bridge
from inspektor_gadget_tpu_torch.utils import syscalls as PS

torch.set_num_threads(2)

SMALL = {"depth": "3", "log2-width": "10", "hll-p": "8", "entropy-log2-width": "6",
         "topk": "8", "harvest-interval": "1h", "invertible": "true",
         "inv-log2-buckets": "9", "quantiles": "true"}
BATCHES, BATCH = 3, 1024
IDENTITY = ("timestamp", "node", "namespace", "pod", "container")


class _Run:
    """One package's LocalRuntime run of <category>/<name> on
    pysynthetic, cancelled from the batch callback after `batches`
    batches."""

    def __init__(self, port: bool, category: str, name: str, params: dict | None = None,
                 sketch: bool = False, output: str = "columns"):
        G, Pm, Ops = (PG, PPm, POps) if port else (RG, RPm, ROps)
        desc = G.get(category, name)
        gp = desc.params().to_params()
        for k, v in {"source": "pysynthetic", "seed": "7", "batch-size": str(BATCH),
                     "rate": "1e9", **(params or {})}.items():
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
                                   extra={"on_sketch_summary": self.summaries.append,
                                          "output": output}, **kw)
        self.batches = 0
        self.events = 0

        def batch_cb(batch):
            self.batches += 1
            self.events += batch.count
            if self.batches == BATCHES:
                self.ctx.cancel()

        runtime = LocalRuntime() if port else RefLocalRuntime()
        on_event = self.rows.append if category == "audit" else None
        out = runtime.run_gadget(self.ctx, on_event=on_event, on_batch=batch_cb)
        self.result = out["local"]

    def json_rows(self) -> list[dict]:
        out = []
        for ev in self.rows:
            d = json.loads(self.ctx.columns.to_json(ev))
            for k in IDENTITY:
                d.pop(k, None)
            out.append(d)
        return out


def _pair(category, name, **kw) -> tuple[_Run, _Run]:
    ref, port = _Run(False, category, name, **kw), _Run(True, category, name, **kw)
    assert ref.result.error is None and port.result.error is None, port.result.error
    assert port.batches == ref.batches == BATCHES
    assert port.events == ref.events == BATCHES * BATCH
    return ref, port


# -- the syscall table ----------------------------------------------------------

def test_syscall_table_matches_the_reference():
    assert PS._NAMES == RS._NAMES and PS._NUMBERS == RS._NUMBERS
    assert PS.all_names() == RS.all_names()
    for nr in range(461):
        assert PS.syscall_name(nr) == RS.syscall_name(nr), nr
    for name in RS.all_names() + ["syscall_500", "no_such_call", ""]:
        assert PS.syscall_number(name) == RS.syscall_number(name), name
    assert PS.syscall_name(257) == "openat" and PS.syscall_number("openat") == 257


# -- the policy generators ------------------------------------------------------

def _syscall_sets(seed: int) -> list[set[str]]:
    rng = np.random.default_rng(seed)
    names = RS.all_names()
    return [set(rng.choice(names, size=k, replace=False).tolist())
            for k in (0, 1, 7, 60, len(names))]


@pytest.mark.parametrize("seed", (0, 1))
def test_seccomp_profile_generators_match_the_reference(seed):
    """Byte-equal JSON and YAML for seeded syscall sets, user names with
    YAML metacharacters and both default actions."""
    for calls in _syscall_sets(seed):
        for action in ("SCMP_ACT_ERRNO", "SCMP_ACT_KILL"):
            got = PSP.generate_oci_seccomp_profile(calls, action)
            assert json.dumps(got, indent=2) == json.dumps(
                RSP.generate_oci_seccomp_profile(calls, action), indent=2)
            for name, ns in (("web-1", ""), ('we"ird: {name}', "team-a"), ("x", "a: b")):
                assert PSP.generate_seccomp_profile_cr(name, calls, ns, action) == \
                    RSP.generate_seccomp_profile_cr(name, calls, ns, action)


def _flows(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = {"namespace": str(rng.choice(["", "default", "team-a"])),
             "egress": bool(rng.integers(2)),
             "port": int(rng.choice([53, 80, 443, 8080])),
             "peer_ns": str(rng.choice(["", "kube-system"])),
             "peer_selector": str(rng.choice(["", "app=db", "app=cache"]))}
        if rng.integers(2):
            f["pod_selector"] = str(rng.choice(["app=web", "app=api", ""]))
        else:
            f["pod"] = str(rng.choice(["", "role=front"]))
        if rng.integers(2):
            f["proto"] = str(rng.choice(["tcp", "udp"]))
        out.append(f)
    return out


@pytest.mark.parametrize("seed", (3, 4))
def test_network_policy_generators_match_the_reference(seed):
    flows = _flows(seed, 200)
    got = PNP.generate_policies(flows)
    assert got == RNP.generate_policies(flows) and got.count("kind: NetworkPolicy") > 3
    assert PNP.generate_policies([]) == RNP.generate_policies([]) == ""
    rules = [{"peer_selector": "app=db", "peer_ns": "kube-system", "port": 5432,
              "proto": "tcp"}, {"peer_selector": "", "peer_ns": "", "port": 53, "proto": "udp"}]
    for ingress, egress in ((rules, []), ([], rules), (rules, rules[:1])):
        assert PNP._yaml_policy("ns", "p", "app=web", ingress, egress) == \
            RNP._yaml_policy("ns", "p", "app=web", ingress, egress)
    assert PNP._yaml_policy("ns", "p", "", [], []) == RNP._yaml_policy("ns", "p", "", [], [])


# -- the gadgets through LocalRuntime -------------------------------------------

def test_audit_seccomp_rows_match_the_reference():
    ref, port = _pair("audit", "seccomp")
    want, got = ref.json_rows(), port.json_rows()
    assert len(got) == len(want) == BATCHES * BATCH
    assert list(got[0]) == list(want[0]) and got == want
    assert {r["code"] for r in got} == {"SYNTH"}


RESULT_CASES = [("advise", "seccomp-profile", {"format": "oci"}),
                ("advise", "seccomp-profile", {"format": "cr", "profile-name": "web"}),
                ("advise", "network-policy", {}),
                ("traceloop", "traceloop", {}),
                ("traceloop", "traceloop", {"ring-size": "16"})]


@pytest.mark.parametrize("category,name,params", RESULT_CASES,
                         ids=["seccomp-oci", "seccomp-cr", "network-policy", "traceloop",
                              "traceloop-ring-16"])
def test_result_bytes_match_the_reference(category, name, params):
    """The result bytes, exactly; the traceloop table has no timestamp
    column, and its JSON form is compared without the timestamps."""
    ref, port = _pair(category, name, params=params)
    got, want = port.result.result, ref.result.result
    assert isinstance(got, bytes) and got == want and len(got) > 200
    if name == "seccomp-profile" and params["format"] == "oci":
        assert len(json.loads(got)) == 64  # a profile a synthetic mount namespace
    if name == "traceloop":
        ref, port = _pair(category, name, params=params, output="json")
        strip = [[{k: v for k, v in r.items() if k != "timestamp"} for r in json.loads(x)]
                 for x in (port.result.result, ref.result.result)]
        assert strip[0] == strip[1] and len(strip[0]) == 200


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


@pytest.mark.parametrize("category,name", [("audit", "seccomp"), ("traceloop", "traceloop")])
def test_sketch_summary_matches_the_reference(category, name, monkeypatch):
    plain = []
    monkeypatch.setattr(K, "fused_planes_plain",
                        lambda *a, _f=K.fused_planes_plain: plain.append(1) or _f(*a))
    launches = K.fused_planes.launches
    ref, port = _pair(category, name, sketch=True)
    got, want = port.summaries[-1], ref.summaries[-1]
    assert got.events == want.events == BATCHES * BATCH
    assert got.distinct == want.distinct and got.entropy_bits == want.entropy_bits
    _assert_summaries_equal(got, want)
    # K2's plain version once a batch on the CPU, the kernel never
    assert len(plain) == BATCHES and K.fused_planes.launches == launches


# -- the real-capture branches on hand-built batches ----------------------------

VOCAB = {201: "openat(AT_FDCWD, \"/etc/hostname\", O_RDONLY) = 3", 202: "read(3, ...) = 12",
         203: "chown(\"/tmp/x\", 1, 1) = -1 EPERM"}


class _Vocab:
    def vocab_lookup(self, key: int) -> str:
        return VOCAB.get(int(key), "")


def _ret(nr: int, ret: int) -> int:
    return (nr << 32) | (ret & 0xFFFFFFFF)


# audit seccomp: ptrace ERRNO rows (EPERM, EACCES, success dropped), SIGSYS
# and another signal, host-wide audit records (action names, data bits, an
# unknown action)
SECCOMP_ROWS = [
    {"kind": 18, "aux2": _ret(92, -1)}, {"kind": 18, "aux2": _ret(260, -13)},
    {"kind": 18, "aux2": _ret(0, 12)}, {"kind": 18, "aux2": _ret(59, -2)},
    {"kind": 9, "aux2": 31}, {"kind": 9, "aux2": 15},
    {"kind": 22, "aux1": 169, "aux2": 0x80000000},
    {"kind": 22, "aux1": 1, "aux2": 0x00030000 | 7},
    {"kind": 22, "aux1": 39, "aux2": 0x7ffc0000},
    {"kind": 22, "aux1": 500, "aux2": 0x12340000 | 5},
]


def _batch(Batch, rows: list[dict]):
    b = Batch.alloc(len(rows))
    b.count = len(rows)
    for i, r in enumerate(rows):
        for k, v in {"ts": 1000 + i, "mntns": 4026531840 + i % 3, "pid": 7 + i, **r}.items():
            b.cols[k][i] = v
        b.comm[i, :4] = np.frombuffer(b"sh\0\0", np.uint8)
    return b


def _gadget(G, category: str, name: str, port: bool, params: dict | None = None):
    desc = G.get(category, name)
    gp = desc.params().to_params()
    gp.set("source", "pysynthetic")
    for k, v in (params or {}).items():
        gp.set(k, v)
    kw = {"device": "cpu"} if port else {}
    ctx = G.GadgetContext(desc, gadget_params=gp, **kw)
    g = desc.new_instance(ctx)
    g.source = g._current_source = _Vocab()
    g._is_native = True
    return g, ctx


def test_audit_seccomp_decode_matches_the_reference():
    out = []
    for G, Batch, port in ((RG, RB.EventBatch, False), (PG, PB.EventBatch, True)):
        g, _ = _gadget(G, "audit", "seccomp", port)
        b = _batch(Batch, SECCOMP_ROWS)
        out.append([None if ev is None else dataclasses.asdict(ev)
                    for ev in (g.decode_row(b, i) for i in range(b.count))])
    want, got = out
    assert got == want
    assert [(r["syscall"], r["code"]) if r else None for r in got] == [
        ("chown", "ERRNO"), ("fchownat", "ERRNO"), None, None, ("?", "KILL_THREAD"), None,
        ("reboot", "KILL_PROCESS"), ("write", "TRAP"), ("getpid", "LOG"),
        ("syscall_500", "0x12340000")]


def _syscall_stream(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"kind": 18, "key_hash": int(rng.choice([201, 202, 203, 999])),
             "aux2": _ret(int(rng.choice([0, 1, 3, 59, 92, 257, 322])),
                          int(rng.integers(-20, 20)))} for _ in range(n)]


@pytest.mark.parametrize("ring", ("4096", "5"))
def test_traceloop_native_rings_match_the_reference(ring):
    """Rings of the ptrace syscall stream (nr, the vocab's decoded line,
    the signed return) over three batches, with overwrite at ring 5."""
    out = []
    for G, Batch, port in ((RG, RB.EventBatch, False), (PG, PB.EventBatch, True)):
        g, _ = _gadget(G, "traceloop", "traceloop", port, {"ring-size": ring})
        for seed in range(3):
            g.process_batch(_batch(Batch, _syscall_stream(40, seed)))
        out.append(([dataclasses.asdict(r) for r in g.read()],
                    [dataclasses.asdict(r) for r in g.read(4026531841)],
                    {ns: list(r) for ns, r in g._rings.items()}))
    assert out[1] == out[0]
    rows = out[1][0]
    assert len(rows) == (120 if ring == "4096" else 15)
    assert any(r["args"] == VOCAB[201] and r["syscall"] in PS.all_names() for r in rows)


def test_traceloop_ring_overwrites_oldest():
    """tests/test_gadgets.py's overwrite case in both packages: a ring of
    16 keeps the last 16 of 100 rows."""
    out = []
    for G, Batch, port in ((RG, RB.EventBatch, False), (PG, PB.EventBatch, True)):
        g, _ = _gadget(G, "traceloop", "traceloop", port, {"ring-size": "16"})
        g._is_native = False
        b = Batch.alloc(100)
        b.cols["mntns"][:] = 42
        b.cols["ts"][:] = np.arange(100)
        b.cols["aux2"][:] = np.arange(100)
        b.cols["aux1"][:] = np.arange(100) * 977
        b.count = 100
        g.process_batch(b)
        out.append([dataclasses.asdict(r) for r in g.read(42)])
    assert out[1] == out[0]
    assert len(out[1]) == 16 and out[1][-1]["timestamp"] == 99


def test_advise_seccomp_profile_native_matches_the_reference():
    """The exact syscall set of a ptrace stream: each mount namespace's
    profile is the reference's."""
    out = []
    for G, Batch, port in ((RG, RB.EventBatch, False), (PG, PB.EventBatch, True)):
        g, _ = _gadget(G, "advise", "seccomp-profile", port)
        for seed in range(3):
            g.process_batch(_batch(Batch, _syscall_stream(50, seed)))
        out.append(dict(g._per_container))
    assert out[1] == out[0] and len(out[1]) == 3
    assert set().union(*out[1].values()) == {0, 1, 3, 59, 92, 257, 322}


def test_explicit_synthetic_runs_never_build_the_library(monkeypatch):
    asked = []

    def refuse():
        asked.append(1)
        raise RuntimeError("native capture library refused by the test")

    monkeypatch.setattr(bridge.LIBRARY, "get", refuse)
    for category, name in (("audit", "seccomp"), ("advise", "seccomp-profile"),
                           ("advise", "network-policy"), ("traceloop", "traceloop")):
        for mode in ("pysynthetic", "synthetic"):
            desc = PG.get(category, name)
            gp = desc.params().to_params()
            gp.set("source", mode)
            desc.new_instance(PG.GadgetContext(desc, gadget_params=gp, device="cpu"))
    assert not asked
