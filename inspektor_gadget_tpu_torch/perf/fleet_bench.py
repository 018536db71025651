"""Fleet-aggregation-tier bench → schema-valid PerfRecords (the port's
copy of ``inspektor_gadget_tpu/perf/fleet_bench.py``).

The tier's cost model is a scaling claim — one
merged fleet query through the merge tree stays cheap as the fleet
grows, because the client's link folds fan-in frames instead of N and
every aggregator folds a bounded child set. This bench drives the
in-process SimFleet at agents ∈ {4, 16, 64, 100} through BOTH paths:

- ``fleet-merge-tree``: fold_tree over the auto-balanced fan-in-4 tree
  (client-driven, so the measured fold includes every tier's seal);
- ``fleet-flat-fold``: the pre-tree client loop (one summary per node,
  one flat merge).

Each (series, N) pair is its own gated ledger series (metric
``query_agentsN``, queries/s, higher is better), so a scale regression
at 100 agents gates exactly like a speed regression at 4. Wire
accounting rides ``extra``: frames and bytes crossing the CLIENT's
link (the tree's whole point — fan-in of them instead of N) plus total
window-frames moved anywhere (edges + 1 for the tree — it pays MORE
total hops to keep every single link bounded).

The byte-identity of the two paths' answers is asserted here too — a
bench that measured two different folds would be comparing nothing.

Host work only (numpy window algebra): the records name the device the
process acquired, as every bench module's do. Run standalone (`python -m
inspektor_gadget_tpu_torch.perf.fleet_bench [--device cuda|cpu] [--ledger
PATH] [--agents 4,16,64,100]`) or from tests with small N.
"""

from __future__ import annotations

import argparse
import time

FLEETS = (4, 16, 64, 100)
FAN_IN = 4


def measure_fleet(n_agents: int, *, fan_in: int = FAN_IN,
                  repeat: int = 3) -> dict:
    """Best-of-`repeat` wall time for one merged query via the tree and
    via the flat fold, over one SimFleet; plus wire accounting."""
    from ..fleet import flat_summary, fold_tree
    from ..fleet.sim import GADGET, SimFleet
    from ..history import encode_window, pack_frames

    fleet = SimFleet(n_agents, n_windows=1, inv=True, qt=True)
    topo = fleet.topology(f"auto:{fan_in}")
    summaries = [fleet.agents[n].summary()["window"]
                 for n in fleet.nodes()]

    def frame_bytes(win) -> int:
        return len(pack_frames([encode_window(win)]))

    tree_s = flat_s = float("inf")
    tf = None
    for _ in range(repeat):
        t0 = time.perf_counter()
        tf = fold_tree(topo, fleet.fetch_leaf, gadget=GADGET)
        tree_s = min(tree_s, max(time.perf_counter() - t0, 1e-9))
        t0 = time.perf_counter()
        flat = flat_summary(summaries, gadget=GADGET)
        flat_s = min(flat_s, max(time.perf_counter() - t0, 1e-9))
    assert tf is not None and tf.window is not None
    if tf.window.digest != flat.digest:  # the tier's contract
        raise AssertionError(
            f"tree fold digest {tf.window.digest[:12]} != flat fold "
            f"{flat.digest[:12]} at {n_agents} agents — refusing to "
            "publish a bench over two different answers")
    leaf_bytes = sum(frame_bytes(w) for w in summaries)
    root_bytes = frame_bytes(tf.window)
    return {
        "agents": n_agents,
        "fan_in": topo.fan_in(),
        "depth": topo.depth(),
        "tree_seconds": tree_s,
        "flat_seconds": flat_s,
        # the client's own link: fan-in merged frames vs one per node
        "tree_client_link_windows": len(topo.root.children),
        "flat_client_link_windows": n_agents,
        "tree_client_link_bytes": root_bytes,
        "flat_client_link_bytes": leaf_bytes,
        # total window-frames moved anywhere in the fold
        "tree_wire_windows": topo.edges() + 1,
        "flat_wire_windows": n_agents,
        "digest": tf.window.digest,
    }


def fleet_records(stats: dict, provenance: dict) -> list[dict]:
    from .schema import make_record
    n = stats["agents"]
    shared = {"agents": n, "fan_in": stats["fan_in"],
              "depth": stats["depth"], "digest": stats["digest"]}
    tree = make_record(
        config="fleet-merge-tree", metric=f"query_agents{n}",
        unit="queries/s", value=1.0 / stats["tree_seconds"],
        stages={"tree_fold": {"seconds": stats["tree_seconds"],
                              "events": float(n)}},
        provenance=provenance,
        extra={**shared,
               "wire_windows": stats["tree_wire_windows"],
               "client_link_windows": stats["tree_client_link_windows"],
               "client_link_bytes": stats["tree_client_link_bytes"]})
    flat = make_record(
        config="fleet-flat-fold", metric=f"query_agents{n}",
        unit="queries/s", value=1.0 / stats["flat_seconds"],
        stages={"flat_fold": {"seconds": stats["flat_seconds"],
                              "events": float(n)}},
        provenance=provenance,
        extra={**shared,
               "wire_windows": stats["flat_wire_windows"],
               "client_link_windows": stats["flat_client_link_windows"],
               "client_link_bytes": stats["flat_client_link_bytes"]})
    return [tree, flat]


def publish(*, fleets: tuple[int, ...] = FLEETS, device="cuda",
            ledger: str | None = None) -> list[dict]:
    """Measure every fleet size and append the records to the ledger;
    returns the records (schema-validated by the append path)."""
    from .ledger import append_record
    from .provenance import acquire_device, device_provenance

    dev, acquired = acquire_device(device)
    prov = device_provenance(dev, acquired)
    records = []
    for n in fleets:
        records.extend(fleet_records(measure_fleet(n), prov))
    for rec in records:
        append_record(rec, path=ledger)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fleet aggregation-tier bench → perf ledger")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $IG_TPU_TORCH_PERF_LEDGER or the "
                         "user's state directory)")
    ap.add_argument("--agents", default=",".join(map(str, FLEETS)),
                    help="comma-separated fleet sizes")
    args = ap.parse_args(argv)
    fleets = tuple(int(x) for x in args.agents.split(",") if x.strip())
    for rec in publish(fleets=fleets, device=args.device, ledger=args.ledger):
        e = rec["extra"]
        print(f"{rec['config']:16s} N={e['agents']:<4d} "
              f"{rec['value']:,.0f} queries/s  "
              f"client link {e['client_link_windows']} frame(s) / "
              f"{e['client_link_bytes']:,d} B  "
              f"total {e['wire_windows']} frame(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
