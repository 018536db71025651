"""The port's seven bench modules (`perf/*_bench.py`, `perf/fanout.py`)
against the JAX package's at small sizes: the deterministic part of each
measurement (errors, decoded keys, quantiles, digests, window, frame and
byte counts, deliveries) equals the reference's on the same seeded
inputs, and each `publish` writes records that both packages' validators
accept into a ledger of the test's own. Rates are measured on the card
(`chip_smoke.py` phase 5o), not compared here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401 — before the reference's agent (circular)
from inspektor_gadget_tpu.perf import accuracy_bench as RA
from inspektor_gadget_tpu.perf import fanout as RF
from inspektor_gadget_tpu.perf import fleet_bench as RFl
from inspektor_gadget_tpu.perf import history_bench as RHi
from inspektor_gadget_tpu.perf import quantile_bench as RQ
from inspektor_gadget_tpu.perf import schema as RS
from inspektor_gadget_tpu.perf import standing_bench as RSt
from inspektor_gadget_tpu_torch.perf import accuracy_bench as PA
from inspektor_gadget_tpu_torch.perf import fanout as PF
from inspektor_gadget_tpu_torch.perf import fleet_bench as PFl
from inspektor_gadget_tpu_torch.perf import history_bench as PHi
from inspektor_gadget_tpu_torch.perf import invertible_bench as PI
from inspektor_gadget_tpu_torch.perf import quantile_bench as PQ
from inspektor_gadget_tpu_torch.perf import schema as PS
from inspektor_gadget_tpu_torch.perf import standing_bench as PSt
from inspektor_gadget_tpu_torch.perf.compare import compare_ledger
from inspektor_gadget_tpu_torch.perf.ledger import read_ledger

from _torch_perf import probe_state  # noqa: F401 — autouse

torch.set_num_threads(2)


def assert_published(records: list[dict], ledger: str, configs: list[str]) -> None:
    assert [r["config"] for r in records] == configs
    for r in records:
        assert PS.validate_record(r) == [] and RS.validate_record(r) == []
        assert r["provenance"]["platform"] == "cpu"
        assert r["provenance"]["probe"]["requested"] == "cpu"
    on_disk = read_ledger(ledger)
    assert on_disk.records == records and not on_disk.skipped
    assert all(r.rc == 0 for r in compare_ledger(on_disk.records))  # fresh series


def test_quantile_bench_merged_quantiles_are_the_references(tmp_path):
    import jax.numpy as jnp

    from inspektor_gadget_tpu.ops.quantiles import dd_init as r_init
    from inspektor_gadget_tpu.ops.quantiles import dd_merge as r_merge
    from inspektor_gadget_tpu.ops.quantiles import dd_quantile as r_quantile
    from inspektor_gadget_tpu.ops.quantiles import dd_update as r_update
    from inspektor_gadget_tpu_torch.ops.quantiles import dd_merge, dd_quantile

    assert np.array_equal(PQ._latencies(4096, 7), RQ._latencies(4096, 7))
    qs = [0.5, 0.9, 0.99, 0.999]
    a, b = PQ.merged_sketch(n_buckets=256, device="cpu")
    got = dd_merge(a, b)
    ra = r_update(r_init(0.01, 256, min_value=1.0), jnp.asarray(RQ._latencies(4096, seed=7)))
    rb = r_update(r_init(0.01, 256, min_value=1.0), jnp.asarray(RQ._latencies(4096, seed=8)))
    want = r_merge(ra, rb)
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert int(got.total) == int(want.total) and int(got.zeros) == int(want.zeros)
    assert np.array_equal(dd_quantile(got, qs).numpy(), np.asarray(r_quantile(want, jnp.asarray(qs))))
    ledger = str(tmp_path / "PERF.jsonl")
    records = PQ.publish(batch=1 << 10, n_buckets=256, seconds=0.05, device="cpu", ledger=ledger)
    assert_published(records, ledger, ["quantile-update", "quantile-merge"])


def test_accuracy_bench_observed_error_is_the_references(tmp_path):
    kw = dict(events=40_000, batch=4096, vocab=2048, capacity=128, log2_width=8)
    got = PA.measure_observed_err(device="cpu", **kw)
    want = RA.measure_observed_err(**kw)
    assert got == want
    assert got["observed_err_pct"] > 0  # a width that collides: the check has teeth
    assert np.array_equal(PA._zipf_keys(1000, seed=3), RA._zipf_keys(1000, seed=3))
    ledger = str(tmp_path / "PERF.jsonl")
    records = PA.publish(batch=1 << 10, capacity=64, seconds=0.05, events=20_000,
                         device="cpu", ledger=ledger)
    assert_published(records, ledger,
                     ["accuracy-audit", "accuracy-overhead", "accuracy-observed-err"])
    assert 0.0 <= records[1]["value"] <= 1.0
    err = records[2]["extra"]
    assert err["observed_err_pct"] <= err["bound_pct"]


def test_invertible_bench_decode_is_the_references(tmp_path):
    import jax.numpy as jnp

    from inspektor_gadget_tpu.ops.invertible import inv_decode as r_decode
    from inspektor_gadget_tpu.ops.invertible import inv_init as r_init
    from inspektor_gadget_tpu.ops.invertible import inv_update as r_update

    stats = PI.measure_decode(n_keys=128, rows=2, log2_buckets=9, reps=1, device="cpu")
    _s, keys, counts = PI.loaded_sketch(n_keys=128, rows=2, log2_buckets=9, device="cpu")
    ref = r_update(r_init(2, 9), jnp.asarray(keys), jnp.asarray(counts.astype(np.int32)))
    want = r_decode(ref)
    assert stats["complete"] and want.complete
    assert stats["decoded"] == want.keys
    assert sorted(stats["decoded"]) == sorted(zip(keys.tolist(), counts.tolist()))
    with pytest.raises(ValueError, match="exceeds decode capacity"):
        PI.measure_decode(n_keys=10_000, rows=2, log2_buckets=9, device="cpu")
    ledger = str(tmp_path / "PERF.jsonl")
    records = PI.publish(batch=1 << 10, n_keys=128, rows=2, log2_buckets=9, seconds=0.05,
                         device="cpu", ledger=ledger)
    assert_published(records, ledger, ["inv-update", "inv-decode"])
    assert records[1]["extra"]["complete"] == 1.0


def test_standing_bench_windows_are_the_references(tmp_path):
    got, want = PSt.make_windows(24), RSt.make_windows(24)
    assert [w.digest for w in got] == [w.digest for w in want]
    cache = PSt.measure_cache_hit(range_windows=4, windows=got, steps=16)
    assert cache["folds_during_reads"] == 0
    ledger = str(tmp_path / "PERF.jsonl")
    records = PSt.publish(range_small=4, range_large=8, steps=8, device="cpu", ledger=ledger)
    assert_published(records, ledger,
                     ["standing-refresh", "standing-recompute", "standing-cache-hit"])
    assert records[0]["extra"]["range_small"] == 4 and records[0]["extra"]["range_large"] == 8


FLEET_COUNTS = ("agents", "fan_in", "depth", "tree_client_link_windows",
                "flat_client_link_windows", "tree_client_link_bytes",
                "flat_client_link_bytes", "tree_wire_windows", "flat_wire_windows", "digest")


def test_fleet_bench_wire_counts_are_the_references(tmp_path):
    for n in (4, 16):
        got, want = PFl.measure_fleet(n, repeat=1), RFl.measure_fleet(n, repeat=1)
        assert {k: got[k] for k in FLEET_COUNTS} == {k: want[k] for k in FLEET_COUNTS}
        assert got["tree_client_link_windows"] < got["flat_client_link_windows"] or n == 4
    ledger = str(tmp_path / "PERF.jsonl")
    records = PFl.publish(fleets=(4,), device="cpu", ledger=ledger)
    assert_published(records, ledger, ["fleet-merge-tree", "fleet-flat-fold"])


def test_history_bench_window_and_byte_counts_are_the_references(tmp_path):
    keys = ("windows", "super_windows", "bytes_reclaimed")
    got, want = PHi.measure_compaction(16), RHi.measure_compaction(16)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    keys = ("windows", "pushdown_wire_bytes", "fetch_wire_bytes", "wire_ratio")
    got, want = PHi.measure_pushdown(16), RHi.measure_pushdown(16)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["pushdown_wire_bytes"] < got["fetch_wire_bytes"]
    ledger = str(tmp_path / "PERF.jsonl")
    records = PHi.publish(n_windows=16, device="cpu", ledger=ledger)
    assert_published(records, ledger, ["history-compaction", "history-pushdown"])


def test_fanout_delivers_every_message_as_the_reference(tmp_path):
    for k in (1, 4):
        got, want = PF.measure_fanout(k, messages=300), RF.measure_fanout(k, messages=300)
        assert (got["delivered"], got["drops"]) == (want["delivered"], want["drops"]) \
            == (300 * k, 0)
    ledger = str(tmp_path / "PERF.jsonl")
    records = PF.publish((1, 2), messages=200, device="cpu", ledger=ledger)
    assert_published(records, ledger, ["shared-fanout-k1", "shared-fanout-k2"])


@pytest.mark.parametrize("mod", [PQ, PA, PI, PHi, PSt, PFl, PF], ids=lambda m: m.__name__.split(".")[-1])
def test_publish_on_cuda_without_a_card_raises(mod, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ledger = tmp_path / "PERF.jsonl"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.. is false"):
        mod.publish(ledger=str(ledger))
    assert not ledger.exists()
