"""The port's column system (`inspektor_gadget_tpu_torch.columns`, with
``trace/exec``'s `ExecEvent` and row decoder) against the reference's.

One EventBatch, made from a numpy seed with comm prefixes and a fixed
clock, is decoded into ExecEvent rows by each package's gadget; the text
formatter's header, rows and table, the JSON and dict forms, the
columnar filter masks and the sort orders must be the same, byte for
byte, in both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import columns as RC
from inspektor_gadget_tpu.columns.filter import numeric_col_mask as ref_numeric_col_mask
from inspektor_gadget_tpu.gadgets import GadgetContext as RefGadgetContext
from inspektor_gadget_tpu.gadgets import get as ref_get
from inspektor_gadget_tpu.sources.batch import EventBatch as RefEventBatch
from inspektor_gadget_tpu_torch import columns as PC
from inspektor_gadget_tpu_torch.columns.filter import numeric_col_mask
from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
from inspektor_gadget_tpu_torch.sources.batch import EventBatch

torch.set_num_threads(2)

N = 257
FILTERS = ["pid:>25000", "uid:2", "uid:!2", "ppid:<=3000", "mountnsid:>=4026531872",
           "comm:proc-3", "comm:~^proc-1", "timestamp:1700000000000000100", "pid:07"]
SORTS = ["-pid", "comm,-uid", "uid,ppid,-timestamp", "-mountnsid,pid"]


def _batch(cls):
    """N rows of seeded wire columns with NUL-padded comm prefixes."""
    rng = np.random.default_rng(11)
    b = cls.alloc(N)
    b.cols["ts"][:] = 1_700_000_000_000_000_000 + rng.integers(0, 200, N).astype(np.uint64)
    b.cols["key_hash"][:] = rng.integers(1, 2**63, N, dtype=np.uint64)
    b.cols["mntns"][:] = np.uint64(4026531840) + rng.integers(0, 64, N).astype(np.uint64)
    b.cols["pid"][:] = rng.integers(1000, 51000, N, dtype=np.uint32)
    b.cols["ppid"][:] = rng.integers(1, 5000, N, dtype=np.uint32)
    b.cols["uid"][:] = rng.integers(0, 4, N, dtype=np.uint32)
    b.cols["kind"][:] = 1
    names = [f"proc-{int(i)}".encode()[:8] for i in rng.zipf(1.3, N) % 40]
    for i, nm in enumerate(names):
        b.comm[i, :len(nm)] = np.frombuffer(nm, np.uint8)
    b.count = N
    return b


@pytest.fixture(scope="module")
def rows():
    """(reference columns, reference rows, port columns, port rows, the
    two batches) for one seeded batch."""
    rctx = RefGadgetContext(ref_get("trace", "exec"))
    pctx = GadgetContext(get("trace", "exec"))
    rb, pb = _batch(RefEventBatch), _batch(EventBatch)
    rrows = rctx.desc.new_instance(rctx).decode_rows(rb, range(N))
    prows = pctx.desc.new_instance(pctx).decode_rows(pb, range(N))
    return rctx.columns, rrows, pctx.columns, prows, rb, pb


def test_formatter_and_json_are_byte_identical(rows):
    rcols, rrows, pcols, prows, _, _ = rows
    assert [c.name for c in pcols.all()] == [c.name for c in rcols.all()]
    rf, pf = RC.TextFormatter(rcols), PC.TextFormatter(pcols)
    assert pf.header() == rf.header()
    assert [pf.format_event(e) for e in prows] == [rf.format_event(e) for e in rrows]
    assert pf.format_table(prows[:40]) == rf.format_table(rrows[:40])
    assert [pcols.to_json(e) for e in prows] == [rcols.to_json(e) for e in rrows]
    assert [pcols.to_dict(e) for e in prows] == [rcols.to_dict(e) for e in rrows]
    rcols.set_visible(["pid", "comm", "uid"])
    pcols.set_visible(["pid", "comm", "uid"])
    assert PC.TextFormatter(pcols).format_table(prows[:10]) == \
        RC.TextFormatter(rcols).format_table(rrows[:10])


@pytest.mark.parametrize("spec", FILTERS)
def test_filters_match_the_reference(rows, spec):
    """Row matches and, for the wire columns, the columnar masks."""
    rcols, rrows, pcols, prows, rb, pb = rows
    rf, pf = RC.parse_filters(spec, rcols), PC.parse_filters(spec, pcols)
    got = [PC.match_event(e, pf, pcols) for e in prows]
    assert got == [RC.match_event(e, rf, rcols) for e in rrows]
    wire = {"pid": "pid", "ppid": "ppid", "uid": "uid", "mountnsid": "mntns",
            "timestamp": "ts"}.get(pf[0].column)
    if wire is not None and pf[0].op != "re":
        m = numeric_col_mask(pb.cols[wire][:N], pf[0])
        want = ref_numeric_col_mask(rb.cols[wire][:N], rf[0])
        assert (m is None) == (want is None)
        if m is not None:
            assert np.array_equal(m, want)
            assert m.tolist() == got


@pytest.mark.parametrize("spec", SORTS)
def test_sort_orders_match_the_reference(rows, spec):
    rcols, rrows, pcols, prows, _, _ = rows
    got = PC.sort_events(list(prows), PC.parse_sort(spec, pcols), pcols)
    want = RC.sort_events(list(rrows), RC.parse_sort(spec, rcols), rcols)
    assert [pcols.to_json(e) for e in got] == [rcols.to_json(e) for e in want]
    pb = pcols.tensorize(prows)
    rb = rcols.tensorize(rrows)
    assert np.array_equal(PC.columnar_argsort(pb, PC.parse_sort(spec, pcols), pcols),
                          RC.columnar_argsort(rb, RC.parse_sort(spec, rcols), rcols))


def test_group_and_fnv_hash_match_the_reference(rows):
    from inspektor_gadget_tpu.columns.columns import fnv1a64 as ref_fnv
    from inspektor_gadget_tpu_torch.columns.columns import fnv1a64
    from inspektor_gadget_tpu_torch.sources import synthetic
    rcols, rrows, pcols, prows, _, _ = rows
    got = PC.group_events(list(prows), ["uid"], pcols)
    want = RC.group_events(list(rrows), ["uid"], rcols)
    assert [pcols.to_json(e) for e in got] == [rcols.to_json(e) for e in want]
    assert synthetic.fnv1a64 is fnv1a64  # one home
    for s in ("", "proc-1", "bash", "ü"):
        assert fnv1a64(s) == ref_fnv(s)
