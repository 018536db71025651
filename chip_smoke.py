#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Builds the port's CUDA kernels from ``inspektor_gadget_tpu_torch/csrc``
(one nvcc per source, all started together), holds each against its
plain PyTorch version on the card at the main paths' shapes, then drives
the two main paths. K1 and K2 are also held, with torch.equal, on
stress inputs: one hot key in every row, weights near 2**31 that wrap,
n = 100003 and n = 33 with lanes that are rows of one (5, n) tensor (so
rows 1-4 start off 16 bytes), count-min rows of 2**18 and 2**20, HLL p
16; their launch plans (blocks, jobs, shared memory a block, blocks
resident an SM by cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
ptxas' registers and spills are logged.

The sketch-ingest path: a seeded zipf stream (vocab 5000, s 1.2) of
2**17-event batches through the pinned pool, the H2D stager and
`bundle_ingest_step` at the production sketch geometry with every plane
on (count-min 4 x 2**16, HLL p 14, entropy 2**12, top-k 128, invertible
3 x 2**12, DDSketch 2048 buckets) (K2). The same stream is also folded
by the plain composition `bundle_update` on the card, whose entropy
update is K1. Both bundles must equal, leaf by leaf, the same fold on
the CPU, where no kernel runs.

The anomaly plane: 8 harvest ticks (one optimizer step, then a score of
every container) of each scorer family at the operator's widths on 128
containers fed by a seeded zipf event stream: ae and vae on 4096-bucket
count vectors (hidden 256, latent 64), seq (vocab 512, d_model 128, 4
heads, 2 layers, window 256) on the operator's token matrix with
``attn="flash"`` (K3). The seq scores must agree with the same ticks
through ``attn="full"`` on the card and through the plain path on the
CPU, from the same weights.

The operator (phase 5c): the port's `TpuSketchInstance` at the
production geometry with every plane on (two priority classes splitting
the invertible budget, quantiles, history sealed once a harvest into a
history store under build/chip_smoke_hist/, two standing queries, audit
sample 1024, the seq scorer), fed through its own entry points: a
NativeCapture of the synthetic exec source (vocab 2000) popped into
`folded_block()`s and ingested with `ingest_folded`, a harvest every 16
batches, then 8 seeded EventBatches through `enrich_batch`, then
`post_gadget_run` (final harvest, window and checkpoint). The same
streams through an instance on the CPU must give the same summaries,
checkpoint leaves, store (every segment byte for byte, the npz entries'
zip clock pinned) and standing answers, each of those equal to
`answer_query` over the store's windows in its range (phase 5e(a): the
seal's split, bytes a window and the store's shape are logged).

The gadget framework (phase 5d): ``trace/exec`` with the sketch plane
at the production geometry (every plane the CLI path turns on:
invertible, quantiles on aux1, audit sample 1024, the ae scorer). (a)
`LocalRuntime().run_gadget` on the pysynthetic source (seed 7, vocab
2000), cancelled from the batch callback after 32 batches of 2**17, on
the card and then on the CPU: the final summaries must agree (estimates
bit for bit, ae scores within 5%) and K2 must run once a batch. (b)
The CLI, ``trace exec --source synthetic --rate 30000000 --timeout 10
-F uid:99`` with the same sketch flags, as a subprocess: it must exit 0
and print at least 5 sketch epochs, each with heavy hitters; its
events/s, drops and harvest times are logged beside phase 5c's.

The history route (phase 5e(b)): 5d(b)'s CLI run again with
``--tpusketch-history true`` (a window a second into a store under
build/) and phase 5c's standing queries, then ``query`` and ``history
tiers`` as two subprocesses at once (they only read the store), and
``history compact``, ``query``, ``history archive`` and ``query
--archive-dir`` in turn in one more (one import of torch for the four,
since phase 5l came), each exiting 0: the first
answer's events must equal the listed windows' sum and the run's last
summary; the compacted and the rehydrated answers must equal the first
in events, distinct, entropy and heavy hitters. Each subprocess's wall
time and the time of torch's import and of the history functions in it
are logged.

Capture, alerts and replay (phase 5f): (a) 5d(a)'s run, cut to 16
batches (32 until phase 5k came), with the history plane sealing a window a harvest, a harvest every 4 batches, five JSON
alert rules on sketch fields and the capture operator journaling it
(unlimited retention: the journal outgrows the default 256 MB); the same
run without capture; then `replay_journal` of the journal twice on the
card and once on the CPU. Each card replay must reproduce the recorded
summary digests (ae scores included) and alert transitions, launch K2
once a replayed batch and reseal the recorded run's windows; the CPU
replay's summaries must equal the card's (estimates bit for bit, ae
within 5%), with the same transitions and windows; the journal must hold
the run-end resolve. (b) The CLI, ``trace exec --source synthetic --rate
2000000 --timeout 5 -F uid:99`` with the same flags plus
``--capture-dir``, ``--capture-retention-bytes 0`` and
``--alerts-rules-file``, then ``record inspect``, ``replay --verify -o
json``, ``alerts rules`` and ``alerts test --journal``, each a subprocess
(all four at once) that must exit 0, the replay reporting ``digests_match`` and
``alerts_match``. Events/s with and without capture, journal bytes a
batch, replay events/s on the card and on the CPU and each subprocess's
wall time (torch's import timed) are logged.

The harvest's entropy across devices (phase 5f, end): 5d(a)'s run for 4
batches with the anomaly plane off, a harvest a batch, recorded on the
card by the capture operator and replayed on the CPU: every harvest's
``entropy_bits`` must equal the card's bit for bit (as every
card-vs-CPU summary comparison of the script requires), and so must
``distinct``, so the replay reports ``digests_match``; the journal is
kept in build/chip_smoke_entropy_journal for a replay by the JAX
package. K1, K2 and K3 are timed before and after phase 5f, and
again at the end.

Container scoping (phase 5g): the localmanager's collection is seeded
with 64 containers, one for each synthetic mount namespace, 16 of them
in namespace team-a. (a) 5d(a)'s run with ``operator.kubemanager.
namespace=team-a`` on the card and on the CPU: equal summaries, events
equal to team-a's share of the stream rebuilt from the seed, K2 once a
non-empty batch; the same on the native synthetic source (the filter in
C++ before the ring) with history slices on: events = popped, the
capture's filtered count closing the seeded stream, every ``mntns:N``
slice of team-a; a decoded-rows run naming every row's container. (b)
A child under ``unshare -m`` exec'ing /bin/true, and ``trace exec
--source native --localmanager-containername <its comm>
--tpusketch-enable true --timeout 5 -o json`` as a subprocess: rows of
the child named as its container, none foreign, the last summary's
events equal to the rows; ``no-such-ctr``, run at the same time, scores
none of the child's.
Where the host lacks root, ``unshare`` or the proc-exec source, (b)
says which and does not run. The host's facts (card count, grpc and
google.protobuf, root, unshare, the proc-exec source, the localmanager's
procfs scan time) are logged after the build.

The trace gadget family (phase 5h): (a) ``trace open``, ``trace tcp``
and ``trace dns`` (the gadgets of the three synthetic kinds) as 5d(a)
runs trace/exec, 8 batches of 2**17 (16 until phase 5l came) on the card
and on the CPU: equal
summaries, K2 once a batch, each one's events/s beside 5d(a)'s; then
the other nine trace gadgets, 2 batches of 8192 with the sketch off,
every row decoded from the synthetic branch (no row of a real event
kind). (b) Every trace gadget whose kernel window the card's host
offers (the `[host]` line prints the window probes, whether /dev/kmsg
reads, CAP_NET_RAW and whether ptrace works), with ``--source native
--tpusketch-enable true`` for 3 s on real activity: open (a child's
file under a temporary directory), bind (a TCP and a UDP listener),
tcp (connects to a local listener), capabilities, signal and fsslower
(a ``--command`` each), dns (queries to 127.0.0.1:53); each run's last
summary counts its rows and K2 ran once a non-empty batch; a gadget
whose window is absent is logged as skipped with its probe. mount and
oomkill are not run on the card's host. Then ``trace tcp --source
native -o json`` as a black box through the port's step framework.

The remaining gadgets (phase 5i, ROADMAP 17b): (a) ``audit seccomp``
(16 batches), ``advise seccomp-profile``, ``advise network-policy`` and
``traceloop`` (4 batches each; network-policy 2 since phase 5k came) as
5d(a) runs trace/exec, on the card and
on the CPU: equal summaries, K2 once a batch on the card and never on
the CPU, and equal result bytes (the profiles' JSON, the policies' YAML,
the traceloop table); each one's events/s beside 5d(a)'s. (b) Each 17b
window the card's host offers (the `[host]` line adds the byte, block
and perf probes and whether /proc/diskstats reads): traceloop, advise
seccomp-profile and audit seccomp on a ``--command`` under ptrace with
the sketch plane on (the openat of
/etc/hostname returning 3; execve, openat, read and close in the
profile, reboot out; the ERRNO row of an unprivileged chown); top
block-io, file, tcp, metrics and self at ``--interval 1s`` beside a
child that fsyncs a file under build/, a local connection of a known
byte count and a native synthetic trace exec; profile cpu (folded and
columns) on a spinning child; profile block-io ``--quantiles true`` on
the card; and profile block-io's DDSketch fold of 10,000 seeded
latencies on the card and on the CPU, equal counts and quantile line.

The agent (phase 5j, ROADMAP 18a): (a) the port's `serve` in this
process on a unix socket under a temp directory, on the card, driven
through `AgentClient`: GetCatalog equals `build_catalog()`; a shared
RunGadget of 5d(a)'s stream (unpaced, outputs summary) with a second,
compatible request riding it as a summary-tier subscriber, ended for
both by the owner's whole-run stop once the source popped 8 batches:
both final summaries one frame but for the seq, K2 once a batch, the
summary equal to `gadget_run` of as many batches on the CPU (distinct and
entropy bit for bit, ae within 5%), its events/s beside 5d(a)'s; then
the same run with a window a harvest (300 ms) under StartRecording:
ListWindows lists a window a harvest with events, QueryWindows equals
`answer_query` over the store, the fetched recording replays on the card
to every recorded digest, DumpState lists the finished shared runs and
the alert table; the server is stopped and waited for. (b) ``ig-tpu-torch
agent --device cuda`` as a subprocess on another socket: ``agent
liveness`` polled until it answers (120 s; the time and torch's import
in the agent are logged), a RunGadget of 2 batches paced at one a second
(stopped when the agent's /metrics counts 2 popped batches; summary
events 2 x 2^17, 2 sketch steps), ``debug state --remote`` exit 0, and
SIGTERM: exit 0 within 30 s and the flight record written. 5e(b)'s CLI
run is 7 s and 5f(b)'s 4 s since 5j came (10 and 5 before).

The fan-out (phase 5k, ROADMAP 18b): (a) two of the port's `serve` in
this process on the card (nodes n0 and n1, unix sockets and the history
store under a temp directory); on each an owner's shared run of 5d(a)'s
stream at full width (pysynthetic seed 7 on n0, 8 on n1) with a harvest
and a window every 300 ms, one summary-tier subscriber a node attached
through `GrpcRuntime.subscribe_summaries`, each run ended for all once
its source popped 8 batches. Both nodes end without error, K2 once a
popped batch, each subscriber's last summary the owner's final frame but
for the seq, `GrpcRuntime.query_history` answered by pushdown on both
nodes and equal to `answer_query` over `canonical_order` of both stores'
windows, and n1's summary equal to `gadget_run` of the same stream,
batches and harvest points on the CPU (distinct and entropy bit for bit,
ae within 5%); the fleet's events/s is logged beside 5j(a)'s single
agent. (b) `deploy_local(2, device="cuda")` (state file under a temp
directory, free loopback ports) starts two ``ig-tpu-torch agent``
subprocesses, polled with ``agent liveness`` (120 s) and warmed by one
run each to a first harvest; then ``ig-tpu-torch trace exec --remote
node-0=...,node-1=... --source pysynthetic --batch-size 4096 --rate 20000
--timeout 3 --tpusketch-enable true`` (5d's sketch flags) ``-o json`` as
a subprocess: exit 0, rows from both nodes, no PARTIAL label. The row
route sends one gRPC message an event, so its batch is cut to 4096 (a
2**17 batch frame passes gRPC's 4 MiB cap); the sketch stays at full
width. `undeploy_local` stops both agents, exit 0 within 30 s each.

Sharded ingest, the collective merge and the fleet tier (phase 5l,
ROADMAP 11): (a) 24 seeded zipf batches of 2**17 (heavy hitters of 100
keys, under top-k's 128, where the streaming candidates are exact on
every path) at the production geometry, pre-staged on the card, dealt
round-robin over 1, 2 and 4 lanes on ["cuda:0"] * n (lanes sharing one
card: a check of the lane algebra, not a deployment), harvested after
batch 13 (mid-round at 2 and 4 lanes: the open round flushed with
zero-weight fillers) and at the end: every merged leaf and the digest's
bytes equal the single-lane `bundle_ingest_step` fold on the card and on
the CPU, K2 once a lane a round; the device-only events/s of 4-lane
rounds against 1-lane ones and the harvest merge's ms are logged. (b)
The operator: unpatched, on a one-card host ``shard-ingest true``
raises the one-device ParamError (and ``chips 2`` its "exceeds the 1
local device(s)" one); with `_lane_devices` patched to [cuda:0, cuda:0],
5d(a)'s `LocalRuntime` run (vocabulary 100) for 16 batches with
``--tpusketch-shard-ingest true --tpusketch-chips 2`` and a harvest
after batch 7 gives the summaries of the unsharded run of the same
stream (estimates bit for bit, ae within 5%), K2 once a lane a round.
(c) A one-rank NCCL group on tcp://127.0.0.1:<free port>, in a process
of its own run beside (b): `make_fleet_merge` over two lane rows (SUM on
int32, int64 and float32, MAX on the HLL registers, all_gather of the
top-k candidates) gives `cluster_merge`'s `bundle_digest`; two ranks
cannot share one card under NCCL, so the two-rank merge is a gloo test
on the CPU. (d) In 5k(b), beside its CLI run and at the same time:
``fleet health --remote``, ``query --remote`` and ``query --remote
--topology auto:2`` over the windows the warm-up runs sealed, each exit
0, the topology answer the flat one's.

The doctor, its CUDA probe and the stress harnesses (phase 5m, ROADMAP
19, 21): ``ig-tpu-torch doctor`` and ``doctor -o json`` as subprocesses
at once, exit 1 if and only if a gadget is unavailable (1 is expected on
the card's host, which lacks most kernel windows); the windows
host_facts() probes through the capture library agree with the doctor's
rows, the gadget rows are the catalog's 30, the toolchain row names nvcc
building sm_90a, and the topology row (this process, CUDA initialised)
names the card; `platform_probe.acquire_platform("cuda")` names torch's
card with compute capability 9.0; ring_stress and source_stress, built
by g++ with the kernels in phase 2 (plain, and under ThreadSanitizer
where g++ takes it; source_stress as root), run at once, each to exit
0. Phase 5j(b) checks the agent's probe line and start-up report.

Training-side parallelism (phase 5n, ROADMAP 13), at the reference's
widths on lanes of cuda:0 (a check of the lane algebra, not a
deployment), each comparison repeated on CPU lanes in the same call:
`make_ep_moe` over 2 and 4 lanes (8192 tokens, d 128, 8 experts of
d_ff 256) against the one-lane MoE routed with each shard's capacity
(2e-2), routing compared card vs CPU; `make_ep_train_step(attn="flash")`
over 2 and 4 lanes (the seq defaults with 8 experts, 16 windows of 256)
against the one-lane step with per-shard capacity, K3 once a lane a
layer, the memory allocated unchanged from step 3 to 8;
`make_sp_train_step` (ring, ulysses) over 4 lanes against
`seq_train_step`; each train step's losses within 1e-3 relative at every
step, and its first step held to the other run's from the same weights:
the gradient (Adam's first moment) within 5e-2 of its leaf's largest,
the update within 5% of lr wherever the gradient is clearly non-zero
(`_update_agrees`); `ring_attention` at [16, 4096, 4, 32] f32 against
`blockwise_attention` (2e-5; the CPU takes 4 of the 16 rows); the
pipeline's forward and SGD step over 4 stages (d 128, d_ff 256) against
the sequential blocks (1e-5 of the output's magnitude); and
`cluster_sketch_step(use_tp=True)` on a 2 x 2 mesh (production sketch
geometry, the AE at 4096 -> 512 -> 128 bf16) against the DP step:
bundles bit-equal, the losses and the first step as the train steps
above, K1 once a node lane a step.

The perf plane (phase 5o, ROADMAP 20): (a) `run_harness("e2e-prod",
device="cuda", seconds=1.5)` (the config's window is 3 s) in this
process, five times: fused; fused with the
invertible and quantile planes; classic; sharded over two lanes of
cuda:0; fused replaying 5f(a)'s journal. Each record validates, says
platform gpu with a probe trail naming the card, counts steps x batch
less its drops in events (the journal's batch counts, cycled, for the
replay) and positive seconds in every stage; K2 launches once a step
(the warm-up's 2 besides) on the fused arms and no K1, K1 once a step on
the classic arm and no K2, K2 once a lane a step on the sharded arm (the
harness checks each of its loops' counts itself on the card). (b) The
seven bench modules' `publish` on the card into the same ledger, at the
reference's default sizes but fanout's message count (5000 of 20000);
their deterministic outputs equal a CPU call's: the merged DDSketch (its
quantiles within 1e-6), the observed count-min error, the decoded keys,
the standing, history, fleet and fan-out counts. (c) ``ig-tpu-torch bench
run --config e2e --device cuda --ledger T -o summary`` as a subprocess
started with (b) (its torch import beside (b)'s benches, its window
beside (b)'s CPU calls; its rate is not a measurement), exit 0,
its two records in the ledger; then `bench compare` and `bench report`
in this process, their exit code and text those of `compare_ledger` and
`render_report` over the ledger.

The launch counts are set to 0 just before each card run of a path and
read just after it.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists each kernel's launches, error and times. The
full report also goes to build/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import queue
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from inspektor_gadget_tpu_torch.profile_step import (HARVEST_EVERY, OP_CONTAINERS,
                                                     OP_EVENT_BATCHES, OP_MNTNS0, WINDOW,
                                                     operator_config, operator_event_batches)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor, f32 CUDA cores
SRC = "inspektor_gadget_tpu_torch/csrc/sketch_kernels.cu"
K3_SRC = "inspektor_gadget_tpu_torch/csrc/flash_attention.cu"
CONTAINERS, SILENT = 128, 4  # containers a node runs; of them, ones with under 4 events
TICKS = 8
SEQ_WINDOW = 256


T0 = time.perf_counter()


def log(msg: str) -> None:
    """One report line, behind the seconds since the script started."""
    print(f"{time.perf_counter() - T0:7.1f}s {msg}", flush=True)


def fill_block(src, block: np.ndarray, i: int) -> None:
    """Batch i of the stream: a ragged tail every 8th batch and
    pre-aggregated slots of weight 3 every 5th."""
    from inspektor_gadget_tpu_torch.sources.synthetic import WEIGHTS
    n = block.shape[1]
    src.fill(block, valid=n - 777 * (i // 8 + 1) if i % 8 == 7 else None)
    if i % 5 == 2:
        block[WEIGHTS, ::10] *= 3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def reset_launches() -> None:
    """Every wrapper's launch count to 0 (each adds one where it launches)."""
    from inspektor_gadget_tpu_torch.ops import kernels as K
    from inspektor_gadget_tpu_torch.parallel import flash_attention as FA
    K.histogram.launches = 0
    K.fused_planes.launches = 0
    FA.flash_attention.launches = 0


def read_launches() -> dict[str, int]:
    from inspektor_gadget_tpu_torch.ops import kernels as K
    from inspektor_gadget_tpu_torch.parallel import flash_attention as FA
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"K1": K.histogram.launches, "K2": K.fused_planes.launches,
            "K3": FA.flash_attention.launches}


def k3_bound(shape, dtype: torch.dtype, causal: bool) -> tuple[float, str]:
    """K3's least time on the card (ms) and what sets it: q, k, v read
    once and o written once over the memory rate, or the causal (or full)
    attention's operations over the peak rate for the inputs' type."""
    b, t, h, d = shape
    nbytes = 4 * b * t * h * d * torch.empty((), dtype=dtype).element_size()
    ops = 2 * b * h * d * t * (t + 1) if causal else 4 * b * h * d * t * t
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_inputs(shape, dtype: torch.dtype, gen: torch.Generator, dev: torch.device):
    """q, k, v as the seq model hands them to K3: strided views of one
    [B, T, 3, H, D] qkv tensor."""
    b, t, h, d = shape
    qkv = torch.randn(b, t, 3, h, d, generator=gen, device=dev).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def k3_err(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor, causal: bool,
           what: str) -> tuple[float, float, float]:
    """Max and mean abs error of K3 against its plain version, and the
    largest share of the tolerance used. Tolerance: 2e-4 + 2e-4·|want|
    (float32, as the JAX tests hold the reference);
    `flash_attention.k3_tolerance` (bfloat16: one rounding step of the
    output, and 2^-9 max|v| for the weights P the tensor cores take in
    bfloat16)."""
    from inspektor_gadget_tpu_torch.parallel.flash_attention import k3_tolerance
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        tol = k3_tolerance(want, v, causal)
    else:
        tol = 2e-4 + 2e-4 * w.abs()
    used = float((err / tol).max())
    require(used <= 1 and got.shape == want.shape and got.dtype == want.dtype,
            f"K3 {what}: max abs err {float(err.max())}, {used:.3g} of the tolerance")
    return float(err.max()), float(err.mean()), used


def hmma_count(lib: Path) -> int:
    """Tensor-core instructions (HMMA lines) in the SASS of a built
    library, read with the CUDA toolkit's cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True)
    return sum("HMMA" in line for line in sass.stdout.splitlines())


class ContainerStream:
    """Per-container event data as the tpusketch operator accumulates it
    (``inspektor_gadget_tpu/operators/tpusketch.py:1518-1538``): each
    container's token window (seq, last `window` tokens) and its event
    count vector over `dim` buckets (ae, vae). Events are a seeded zipf
    key stream (s 1.2, 5000 ranks, offset per container) over CONTAINERS
    containers of skewed activity; SILENT of them send one event in all,
    so they stay under the 4 tokens a seq window needs. The event rate
    (64 a container a tick) and the activity skew (1/rank^0.8) are
    assumed, not taken from a source: they set how many seq rows are
    short, not the shapes K3 and the MLPs run at."""

    def __init__(self, seed: int, vocab: int, dim: int, window: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.vocab, self.dim, self.window = vocab, dim, window
        self.windows: dict[int, list[int]] = {}
        self.counts: dict[int, np.ndarray] = {}
        active = CONTAINERS - SILENT
        p = 1.0 / np.arange(1, active + 1) ** 0.8
        self.p = p / p.sum()
        self.ticks = 0

    def tick(self, events: int = CONTAINERS * 64):
        """One harvest interval of events -> (seq token matrix, its ready
        rows, ae/vae count matrix)."""
        from inspektor_gadget_tpu_torch.models import seq_window_matrix, tokens_from_keys
        ns = self.rng.choice(CONTAINERS - SILENT, events, p=self.p)
        ranks = np.minimum(self.rng.zipf(1.2, events), 5000).astype(np.uint64)
        if self.ticks == 0:
            ns = np.concatenate([ns, np.arange(CONTAINERS - SILENT, CONTAINERS)])
            ranks = np.concatenate([ranks, np.ones(SILENT, np.uint64)])
        self.ticks += 1
        keys = ranks + np.uint64(31) * ns.astype(np.uint64)
        toks = tokens_from_keys(keys, self.vocab)
        buckets = (keys % np.uint64(self.dim)).astype(np.int64)
        for c in np.unique(ns):
            sel = ns == c
            seq = self.windows.setdefault(int(c), [])
            seq.extend(int(t) for t in toks[sel])
            if len(seq) > self.window:
                del seq[:-self.window]
            vec = self.counts.setdefault(int(c), np.zeros(self.dim, np.float32))
            np.add.at(vec, buckets[sel], 1.0)
        mat, n_ready = seq_window_matrix(self.windows.values(), self.window)
        return mat, n_ready, np.stack(list(self.counts.values()))


def run_ticks(scorer, batches, attn: str = "flash", noise=None):
    """harvest_tick over `batches` -> (losses, per-tick scores as numpy,
    per-tick seconds on the host clock, ending in a synchronize). `noise`
    gives the VAE's step noise a tick (default: its own generator's)."""
    from inspektor_gadget_tpu_torch.models import harvest_tick
    losses, scores, secs = [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        loss, sc = harvest_tick(scorer, batch, attn, None if noise is None else noise[i])
        if scorer.device.type == "cuda":
            torch.cuda.synchronize(scorer.device)
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        scores.append(sc.float().cpu().numpy())
    return losses, scores, secs


CAPTURE_BATCHES = 32


class CaptureRun:
    """The native capture leg driven as the tpusketch operator drives it
    (``operators/tpusketch.py:1328-1430``, ``:1757-1806``): a
    NativeCapture of the synthetic exec source pops folded blocks into
    the pinned pool (``pop_folded`` with the value lane), the stager
    copies them to `device`, `bundle_ingest_step` (K2) and the two window
    steps absorb each batch under one fence, and every HARVEST_EVERY
    batches a harvest reads the digest and decodes the invertible plane
    (``inv_decode_device`` with sweeps 2 and the operator's cap, then
    ``inv_decode_finish``), then the window ring advances and the window
    HLL starts afresh. `fold_cpu` folds the same stream, rebuilt from the
    seed at the same batch boundaries, on the CPU."""

    def __init__(self, seed: int, vocab: int, batch: int, prod: dict) -> None:
        self.seed, self.vocab, self.batch, self.prod = seed, vocab, batch, prod
        self.counts: list[int] = []
        self.harvests: list[dict] = []

    def _state(self, device):
        from inspektor_gadget_tpu_torch.ops import hll_init, sketches as S, window as W
        return (S.bundle_init(**self.prod, device=device), W.wcms_init(**WINDOW, device=device),
                hll_init(self.prod["hll_p"], device=device))

    def _harvest(self, bundle, wcms, whll, device) -> tuple[dict, float, float]:
        """One harvest -> (its record in host numpy, device seconds, host seconds)."""
        from inspektor_gadget_tpu_torch.ops import sketches as S, window as W
        from inspektor_gadget_tpu_torch.ops import invertible as I
        t0 = time.perf_counter()
        digest = S.bundle_digest(bundle)
        cap = min(4096, I.inv_capacity(bundle.inv.rows, bundle.inv.log2_buckets))
        dec_dev = I.inv_decode_device(bundle.inv, sweeps=2, cap=cap)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        dec = I.inv_decode_finish(*dec_dev)
        t2 = time.perf_counter()
        rec = {"digest": digest.cpu().numpy(), "decode": dataclasses.asdict(dec),
               "buffer": [x.cpu().numpy() for x in dec_dev[1:3]], "n": int(dec_dev[3]),
               "residual": [x.cpu().numpy() for x in (dec_dev[0].count, dec_dev[0].keysum,
                                                      dec_dev[0].fpsum)],
               # copies: on the CPU .cpu() is the live state, which goes on changing
               "wcms": wcms.slots.cpu().numpy().copy(), "epoch": int(wcms.epoch),
               "whll": whll.registers.cpu().numpy().copy()}
        W.wcms_advance(wcms)
        whll.registers.zero_()
        return rec, t1 - t0, t2 - t1

    def drive(self, dev, batches: int, stats) -> dict:
        """The run on the card; returns its rates and harvest times."""
        from inspektor_gadget_tpu_torch.ops import sketches as S, window as W
        from inspektor_gadget_tpu_torch.sources import H2DStager, PinnedBufferPool
        from inspektor_gadget_tpu_torch.sources.bridge import SRC_SYNTH_EXEC, drain_synthetic
        b = self.batch
        bundle, wcms, whll = self._state(dev)
        pool = PinnedBufferPool(b, lanes=4, max_free=8, device=dev)
        stager = H2DStager(pool, depth=4, device=dev, stats=stats)
        timed = {"dev": 0.0, "host": 0.0}

        def on_batch(blk, fb) -> None:
            blk.numpy()[:, fb.count:] = 0  # the operator zeroes the pad: keys, weights, values 0
            self.counts.append(fb.count)
            k, w, v = stager.stage(blk, (blk[0], blk[1], blk[3]))
            _, fence = S.bundle_ingest_step(bundle, k, k, k, w, values=v)
            W.wcms_ingest_step(wcms, k, w)
            W.hll_ingest_step(whll, k, w)
            if dev.type == "cuda":  # one event after all three steps fences the block
                fence = torch.cuda.Event()
                fence.record(torch.cuda.current_stream(dev))
            stager.fence(fence)
            if len(self.counts) % HARVEST_EVERY == 0:
                rec, d, h = self._harvest(bundle, wcms, whll, dev)
                self.harvests.append(rec)
                timed["dev"] += d
                timed["host"] += h

        try:
            src = drain_synthetic(SRC_SYNTH_EXEC, self.seed, self.vocab, batches * b,
                                  pool.get, on_batch, release=pool.put)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            e2e_s = time.perf_counter() - src["started"]
        finally:
            stager.drain()
        require(src["drops"] == 0, f"native capture dropped {src['drops']} events")
        consumed, dev_s, host_s = src["consumed"], timed["dev"], timed["host"]
        self.final = S.bundle_to_numpy(bundle)
        self.final_window = (wcms.slots.cpu().numpy(), whll.registers.cpu().numpy())
        n_h = max(1, len(self.harvests))
        return {"events": consumed, "batches": len(self.counts), "e2e_s": e2e_s,
                "e2e_ev_per_s": consumed / e2e_s,
                "ingest_ev_per_s": consumed / (e2e_s - dev_s - host_s),
                "source_ev_per_s": batches * b / src["source_s"],
                "full_batches": sum(c == b for c in self.counts),
                "harvests": len(self.harvests), "harvest_device_ms": dev_s / n_h * 1e3,
                "harvest_host_ms": host_s / n_h * 1e3,
                "decodes": [h["decode"] | {"keys": len(h["decode"]["keys"])}
                            for h in self.harvests]}

    def stream(self) -> np.ndarray:
        """The run's folded keys, rebuilt from the seed."""
        from inspektor_gadget_tpu_torch.sources.bridge import SRC_SYNTH_EXEC, synthetic_stream
        return synthetic_stream(SRC_SYNTH_EXEC, self.seed, self.vocab, sum(self.counts))[0]

    def fold_cpu(self) -> tuple[list[dict], list[np.ndarray], tuple, np.ndarray]:
        """The same stream folded on the CPU -> (harvest records, final
        bundle leaves, final window leaves, the keys)."""
        from inspektor_gadget_tpu_torch.ops import sketches as S, window as W
        cpu = torch.device("cpu")
        keys = self.stream()
        bundle, wcms, whll = self._state(cpu)
        out, off = [], 0
        blk = np.zeros((3, self.batch), np.uint32)  # keys, weights, values (0: exec events)
        for i, c in enumerate(self.counts):
            blk[:] = 0
            blk[0, :c] = keys[off:off + c]
            blk[1, :c] = 1
            off += c
            k, w, v = (torch.from_numpy(blk[j].view(np.int32)) for j in range(3))
            S.bundle_ingest_step(bundle, k, k, k, w, values=v)
            W.wcms_ingest_step(wcms, k, w)
            W.hll_ingest_step(whll, k, w)
            if (i + 1) % HARVEST_EVERY == 0:
                out.append(self._harvest(bundle, wcms, whll, cpu)[0])
        return (out, S.bundle_to_numpy(bundle),
                (wcms.slots.numpy().copy(), whll.registers.numpy().copy()), keys)


# the card's and the CPU's seq scorer after the same steps: largest gap of
# a leaf over that leaf's largest magnitude (sound runs on an H100 read at
# most 0.0215, the embedding; the weight matrices 0.006-0.009)
SCORER_RTOL = 0.05


class OperatorRun:
    """The port's `TpuSketchInstance` driven as a gadget run drives the
    reference operator, through its own entry points. Feed (a): a
    NativeCapture of the synthetic exec source popped into the instance's
    pinned blocks (``folded_block`` → ``pop_folded(with_values=True)`` →
    ``ingest_folded``), `batches` full batches' worth at vocab `vocab`,
    with an explicit ``harvest()`` every HARVEST_EVERY batches and one at
    the end. Feed (b): OP_EVENT_BATCHES seeded `EventBatch`es whose
    heavy-hitter (key_hash), distinct (pid) and distribution (aux2)
    columns differ, with mntns, kind and a latency in aux1, through
    ``enrich_batch``, harvested after the 4th and at teardown
    (``post_gadget_run``, which also writes the checkpoint). Every
    harvest seals a window into the history store under
    ``hist_root/<device type>`` and folds it into STANDING_QUERIES, whose
    published answers the record keeps. `replay` feeds the same streams,
    feed (a) rebuilt from the seed at the same batch boundaries, to an
    instance on another device."""

    def __init__(self, seed: int, vocab: int, batch: int, geometry: dict,
                 hist_root: Path) -> None:
        self.seed, self.vocab, self.batch = seed, vocab, batch
        self.config = operator_config(geometry)
        self.hist_root = hist_root
        self.counts: list[int] = []

    def _instance(self, device):
        from inspektor_gadget_tpu_torch.operators import (SketchConfig, SketchContext,
                                                          TpuSketchInstance)
        clock = iter(range(1, 1 << 30))
        store = self.hist_root / torch.device(device).type
        shutil.rmtree(store, ignore_errors=True)
        rec = {"summaries": [], "harvest_ms": [], "seal_ms": [], "answers": [], "store": store}
        ctx = SketchContext(gadget="trace/exec", run_id=f"chip-smoke-{self.seed}", node="node-0",
                            batch_size=self.batch, history_clock=lambda: 1.7e9 + next(clock),
                            on_query_answer=lambda h, p: rec["answers"].append((h, p)),
                            on_sketch_summary=rec["summaries"].append)
        cfg = SketchConfig(**self.config, history_dir=str(store),
                           standing_queries=json.dumps(STANDING_QUERIES))
        return TpuSketchInstance(cfg, ctx, device=device), rec

    def event_batches(self) -> list:
        return operator_event_batches(self.seed + 1, self.batch)

    def _harvest(self, inst, rec) -> None:
        inst.harvest()
        rec["harvest_ms"].append(dict(inst.last_harvest_ms))
        rec["seal_ms"].append(dict(inst.last_seal_ms))

    def _ingest(self, inst, rec, fb) -> None:
        """Feed (a)'s step: one batch, and a harvest every HARVEST_EVERY."""
        inst.ingest_folded(fb)
        self.counts.append(fb.count)
        if len(self.counts) % HARVEST_EVERY == 0:
            self._harvest(inst, rec)

    def _feed_events(self, inst, rec, batches, ckpt_dir: Path) -> None:
        from inspektor_gadget_tpu_torch.operators import set_checkpoint_dir
        for i, b in enumerate(batches):
            inst.enrich_batch(b)
            if i + 1 == OP_EVENT_BATCHES // 2:
                self._harvest(inst, rec)
        set_checkpoint_dir(ckpt_dir)
        try:
            inst.post_gadget_run()  # the final harvest and window, then the checkpoint
        finally:
            set_checkpoint_dir(None)
        rec["harvest_ms"].append(dict(inst.last_harvest_ms))
        rec["seal_ms"].append(dict(inst.last_seal_ms))

    def drive(self, dev, batches: int, ckpt_dir: Path) -> tuple[dict, dict]:
        """The run on `dev` -> (its record, its rates and harvest times)."""
        from inspektor_gadget_tpu_torch.sources.bridge import SRC_SYNTH_EXEC, drain_synthetic
        inst, rec = self._instance(dev)
        events = self.event_batches()
        src = drain_synthetic(SRC_SYNTH_EXEC, self.seed, self.vocab, batches * self.batch,
                              inst.folded_block, lambda _blk, fb: self._ingest(inst, rec, fb))
        if len(self.counts) % HARVEST_EVERY:
            self._harvest(inst, rec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        folded_s = time.perf_counter() - src["started"]
        h_s = sum(h["total"] for h in rec["harvest_ms"]) / 1e3
        consumed = src["consumed"]
        require(src["drops"] == 0 and src["produced"] == consumed,
                f"native capture: {src['drops']} dropped, {src['produced']} made, "
                f"{consumed} ingested")
        n_ev = sum(b.count for b in events)
        t0 = time.perf_counter()
        self._feed_events(inst, rec, events, ckpt_dir)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        events_s = time.perf_counter() - t0
        rec["scorer"] = inst.scorer
        info = {"folded_events": consumed, "folded_batches": len(self.counts),
                "full_batches": sum(c == self.batch for c in self.counts),
                "folded_e2e_ev_per_s": consumed / folded_s,
                "folded_ingest_ev_per_s": consumed / max(folded_s - h_s, 1e-9),
                "event_batch_events": n_ev, "event_batch_e2e_ev_per_s": n_ev / events_s,
                "harvests": len(rec["summaries"]), "windows": len(self.windows(rec)),
                "harvest_ms": rec["harvest_ms"], "seal_ms": rec["seal_ms"]}
        return rec, info

    @staticmethod
    def windows(rec) -> list:
        """The (header, payload) frames the run's store holds."""
        from inspektor_gadget_tpu_torch.history import HISTORY
        return list(HISTORY.fetch_windows(base_dir=str(rec["store"])))

    def replay(self, dev, ckpt_dir: Path) -> dict:
        """The same two feeds on `dev`, feed (a) rebuilt from the seed."""
        from inspektor_gadget_tpu_torch.sources.batch import FoldedBatch
        from inspektor_gadget_tpu_torch.sources.bridge import SRC_SYNTH_EXEC, synthetic_stream
        counts, self.counts = self.counts, []
        keys, mntns = synthetic_stream(SRC_SYNTH_EXEC, self.seed, self.vocab, sum(counts))
        self.keys = keys
        inst, rec = self._instance(dev)
        off = 0
        for c in counts:
            blk = inst.folded_block()
            arr = blk.numpy()
            arr[:4] = 0
            arr[0, :c], arr[1, :c], arr[2, :c] = keys[off:off + c], 1, mntns[off:off + c]
            off += c
            self._ingest(inst, rec, FoldedBatch(lanes=arr, count=c, has_values=True, block=blk))
        if len(self.counts) % HARVEST_EVERY:
            self._harvest(inst, rec)
        require(self.counts == counts, "replay: batch boundaries differ")
        self._feed_events(inst, rec, self.event_batches(), ckpt_dir)
        return rec


def _same(got, want, rtol: float, what: str) -> None:
    """Recursive equality: floats to `rtol`, everything else exactly."""
    if isinstance(want, dict):
        require(isinstance(got, dict) and list(got) == list(want), f"{what}: keys differ")
        for k in want:
            _same(got[k], want[k], rtol, f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        require(len(got) == len(want), f"{what}: {len(got)} != {len(want)} items")
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, rtol, f"{what}[{i}]")
    elif isinstance(want, float):
        require(bool(np.isclose(got, want, rtol=rtol, atol=1e-7)), f"{what}: {got} != {want}")
    else:
        require(got == want, f"{what}: {got!r} != {want!r}")


def compare_summaries(got, want, what: str, *, anomaly_abs: float | None = None,
                      anomaly_rel: float | None = None) -> float:
    """Hold one SketchSummary to another: every field but `pipeline`;
    `distinct` and `entropy_bits` exactly (both estimates are the
    reference's float32 arithmetic on every device), the accuracy block
    to 1e-4, each container's anomaly score within `anomaly_abs` (nats)
    or `anomaly_rel` of the score, the rest exactly. Returns the largest
    anomaly gap (absolute, or relative with `anomaly_rel`)."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    for key in ("distinct", "entropy_bits"):
        require(g[key] == w[key], f"{what} {key}: {g[key]!r} != {w[key]!r} (bit for bit)")
    for key in ("distinct", "entropy_bits"):
        _same(g.pop(key), w.pop(key), 1e-5, f"{what} {key}")
    _same(g.pop("accuracy"), w.pop("accuracy"), 1e-4, f"{what} accuracy")
    ga, wa = g.pop("anomaly"), w.pop("anomaly")
    require((ga is None) == (wa is None) and list(ga or {}) == list(wa or {}),
            f"{what}: scored containers differ")
    gap = 0.0
    if wa and anomaly_rel is not None:
        gap = max(abs(ga[k] - wa[k]) / max(abs(wa[k]), 1e-12) for k in wa)
        require(gap <= anomaly_rel, f"{what}: anomaly scores differ by {gap:.3g} of a score")
    elif wa:
        gap = max(abs(ga[k] - wa[k]) for k in wa)
        require(gap <= anomaly_abs, f"{what}: anomaly scores differ by {gap} nats")
    g.pop("pipeline"), w.pop("pipeline")
    _same(g, w, 0.0, what)
    return gap


# phase 5c's standing queries: heavy hitters over the last 4 windows (one
# a second on the injected clock), and one container's slice with its
# latency quantiles over the whole run
STANDING_QUERIES = [
    {"id": "hot", "stats": ["topk", "cardinality", "entropy"], "range": 3.5, "top": 16},
    {"id": "tenant", "stats": ["topk", "quantiles"], "range": 3600, "key": f"mntns:{OP_MNTNS0}",
     "top": 8}]


@contextlib.contextmanager
def pinned_zip_clock(t: float):
    """The npz payload of a sealed window carries its zip entries' wall
    clock (`zipfile` reads ``time.time()``): two instances seal the same
    bytes only when those entries read one clock. Pins zipfile's clock
    alone; the runs' own clocks keep running."""
    class _Clock:
        def time(self) -> float:
            return t

        def __getattr__(self, name):
            return getattr(time, name)

    zipfile.time = _Clock()
    try:
        yield
    finally:
        zipfile.time = time


def _store_dir(base: Path) -> Path:
    (store,) = [p for p in base.iterdir() if (p / "manifest.json").is_file()]
    return store


def compare_stores(got: Path, want: Path) -> dict:
    """Hold one history store to another: every segment file byte for
    byte, the index rows but their ``sealed_ts`` (the writer's wall
    clock). Returns the segments, index rows and bytes."""
    gs, ws = _store_dir(got), _store_dir(want)
    segs = sorted(p.name for p in gs.glob("seg-*.igj"))
    require(segs and segs == sorted(p.name for p in ws.glob("seg-*.igj")),
            f"history stores: segment files differ ({segs})")
    for name in segs:
        require((gs / name).read_bytes() == (ws / name).read_bytes(),
                f"history stores: {name} differs")

    def rows(d: Path) -> list[dict]:
        out = [json.loads(ln) for ln in (d / "index.jsonl").read_text().splitlines() if ln]
        for r in out:
            r.pop("sealed_ts")
        return out
    index = rows(gs)
    require(index == rows(ws), "history stores: index rows differ")
    return {"segments": len(segs), "index_rows": len(index),
            "bytes": sum((gs / n).stat().st_size for n in segs)}


def check_standing(answers: list, store: Path) -> int:
    """Each published standing answer (header, packed window) equal to
    `answer_query` over the windows the store held in its range at its
    seal tick (one window a seal, so seq = tick); the count of windows
    folded aside, since a standing answer folds one merged window and its
    header counts what it covers. Returns the answers checked."""
    from inspektor_gadget_tpu_torch.history import (HISTORY, answer_query, decode_frames,
                                                    unpack_frames)
    specs = {q["id"]: q for q in STANDING_QUERIES}
    for i, (header, payload) in enumerate(answers):
        q = specs[header["id"]]
        frames, dropped = unpack_frames(payload)
        require(dropped == 0, f"standing answer {i}: torn payload")
        got = answer_query(decode_frames(frames), key=header["key"] or None,
                           top=header["top"]).to_dict()
        ranged = list(HISTORY.fetch_windows(base_dir=str(store),
                                            start_ts=header["end_ts"] - q["range"],
                                            end_seq=header["tick"]))
        want = answer_query(decode_frames(ranged), key=q.get("key"), top=q["top"]).to_dict()
        for d in (got, want):
            del d["windows"], d["levels"]
        require(got == want and header["windows"] == len(ranged),
                f"standing answer {i} ({header['id']}, tick {header['tick']}) differs from "
                f"answer_query over the store's {len(ranged)} windows")
    return len(answers)


def compare_operator_runs(got: dict, want: dict, got_dir: Path, want_dir: Path) -> dict:
    """Hold one operator run to another: every summary field but
    `pipeline` (the HLL and entropy estimates bit for bit, the accuracy
    figures derived from them to 1e-4, anomaly scores to 0.05 nats, the rest
    exactly), the history stores (`compare_stores`), every standing
    answer (header and payload bytes) and each one against the store
    (`check_standing`), and the checkpoint's bundle and class leaves
    exactly. The scorer's
    leaves (bf16 steps on two devices) are held leaf by leaf to
    SCORER_RTOL of the leaf's largest magnitude, its integer leaves
    exactly; the seq key bias, which moves by rounding noise, to Adam's
    step bound instead. Returns the largest gaps and the store's shape."""
    from inspektor_gadget_tpu_torch.models import scorer_leaf_names
    from inspektor_gadget_tpu_torch.utils.checkpoint import load_pytree
    gs, ws = got["summaries"], want["summaries"]
    require(len(gs) == len(ws) > 0, f"{len(gs)} harvests against {len(ws)}")
    worst = {"anomaly_nats": 0.0, "scorer_leaf_rel": 0.0, "scorer_leaf_rel_by_leaf": {}}
    for i, (g, w) in enumerate(zip(gs, ws)):
        gap = compare_summaries(g, w, f"harvest {i}", anomaly_abs=0.05)
        worst["anomaly_nats"] = max(worst["anomaly_nats"], gap)
    worst["store"] = compare_stores(got["store"], want["store"])
    ga, wa = got["answers"], want["answers"]
    require(len(ga) == len(wa) > 0, f"{len(ga)} standing answers against {len(wa)}")
    for i, (g, w) in enumerate(zip(ga, wa)):
        require(g == w, f"standing answer {i}: header or payload bytes differ")
    worst["standing_answers"] = check_standing(ga, got["store"])
    scorer = got["scorer"]
    names = scorer_leaf_names(scorer)
    d, key_bound = scorer.config.d_model, 2 * scorer.config.lr * scorer.steps
    for stem in ("trace-exec", "trace-exec-invclasses", "trace-exec-scorer"):
        gl, wl = load_pytree(got_dir / stem), load_pytree(want_dir / stem)
        require(len(gl) == len(wl), f"checkpoint {stem}: leaf count differs")
        for j, (x, y) in enumerate(zip(gl, wl)):
            require(x.dtype == y.dtype and x.shape == y.shape, f"checkpoint {stem} leaf {j}")
            if not (stem.endswith("scorer") and x.dtype.kind == "f"):
                require(np.array_equal(x, y), f"checkpoint {stem} leaf {j} differs")
                continue
            x, y = x.astype(np.float64), y.astype(np.float64)
            if names[j].endswith("qkv.b") and not names[j].startswith(("mu.", "nu.")):
                # tests/test_torch_seqmodel.py: the key bias moves by rounding noise
                kb = max(np.abs(x[d:2 * d]).max(), np.abs(y[d:2 * d]).max())
                require(kb <= key_bound, f"scorer {names[j]}: key bias {kb} > {key_bound}")
                x, y = np.delete(x, np.s_[d:2 * d]), np.delete(y, np.s_[d:2 * d])
            gap, scale = np.abs(x - y).max(initial=0.0), np.abs(y).max(initial=0.0)
            rel = gap / scale if scale else (0.0 if gap == 0 else float("inf"))
            worst["scorer_leaf_rel_by_leaf"][names[j]] = rel
            worst["scorer_leaf_rel"] = max(worst["scorer_leaf_rel"], rel)
    by_leaf = worst["scorer_leaf_rel_by_leaf"]
    log("[operator] scorer leaves, largest gap over the leaf's scale, worst 8 of "
        f"{len(by_leaf)}: " + ", ".join(f"{k} {by_leaf[k]:.3g}" for k in sorted(
            by_leaf, key=lambda k: -by_leaf[k])[:8]))
    for name, rel in by_leaf.items():
        require(rel <= SCORER_RTOL, f"scorer {name}: {rel:.3g} of the leaf's scale apart "
                                    f"(bound {SCORER_RTOL})")
    return worst


# phase 5d: the gadget framework. The sketch flags of every plane the CLI
# path can turn on, at the production geometry (tpusketch.py:302-488)
GADGET_SKETCH = {"depth": "4", "log2-width": "16", "hll-p": "14", "entropy-log2-width": "12",
                 "topk": "128", "invertible": "true", "inv-rows": "3", "inv-log2-buckets": "12",
                 "quantiles": "true", "quantile-field": "aux1", "audit-sample": "1024",
                 "anomaly": "true", "anomaly-model": "ae"}
GADGET_BATCHES = 32
CLI_SECONDS = 10
HISTORY_CLI_SECONDS = 7  # 5e(b)'s run: 10 s until 5j came; still five harvests and more
# runs the CLI module as `python -m` does (runpy, as __main__), with an
# exit hook that writes the process's metrics snapshot, K2's launches, the
# run span and the operator chain's batch spans to the path given as the
# first argument
CLI_DRIVER = """\
import atexit, json, runpy, sys
dump = sys.argv.pop(1)
def _dump():
    from inspektor_gadget_tpu_torch.ops import kernels as K
    from inspektor_gadget_tpu_torch.telemetry import TRACER, snapshot
    spans = TRACER.export()
    with open(dump, "w") as f:
        json.dump({"metrics": snapshot(), "k2_launches": K.fused_planes.launches,
                   "runs": [s for s in spans if s["name"] == "run/trace/exec"],
                   "batch_starts": [s["start"] for s in spans if s["name"] == "op/tpusketch"]},
                  f)
atexit.register(_dump)
runpy.run_module("inspektor_gadget_tpu_torch.cli.main", run_name="__main__", alter_sys=True)
"""
# runs one ig-tpu-torch subcommand as `python -m` does (runpy, as
# __main__), with torch's import and the history functions the command
# calls timed; an exit hook writes the seconds to the path given as the
# first argument. With ``--steps <json list of argv lists>`` it runs those
# subcommands in turn in this one process (`cli.main.main`), each one's
# output, exit code and times kept apart in the dump
HISTORY_SCRIPT = """\
import atexit, contextlib, io, json, runpy, sys, time
t0 = time.perf_counter()
dump = sys.argv.pop(1)
import torch  # noqa: F401 -- every command of the CLI imports it first
spent = {"torch_import_s": time.perf_counter() - t0}
from inspektor_gadget_tpu_torch import history as H
def timed(owner, name, materialize=False):
    fn = getattr(owner, name)
    def wrapper(*a, **kw):
        t = time.perf_counter()
        try:
            out = fn(*a, **kw)
            return list(out) if materialize else out
        finally:
            spent[name + "_s"] = spent.get(name + "_s", 0.0) + time.perf_counter() - t
    setattr(owner, name, wrapper)
timed(H.HISTORY, "fetch_windows", materialize=True)
for owner, name in ((H, "decode_frames"), (H, "answer_query"), (H.HISTORY, "stats"),
                    (H.HISTORY, "tier_stats"), (H.CompactionEngine, "compact_store"),
                    (H.ArchiveTier, "archive_store")):
    timed(owner, name)
t_cli = time.perf_counter()
if sys.argv[1:2] == ["--steps"]:
    from inspektor_gadget_tpu_torch.cli.main import main
    head, done = {**spent, "cli_import_s": time.perf_counter() - t_cli}, []
    for argv in json.loads(sys.argv[2]):
        spent.clear()
        out, t = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        done.append({"rc": rc, "stdout": out.getvalue(), "cli_s": time.perf_counter() - t,
                     **spent})
        if rc:
            break
    with open(dump, "w") as f:
        json.dump({**head, "steps": done}, f)
    sys.exit(done[-1]["rc"] if done else 0)
def _dump():
    spent["cli_s"] = time.perf_counter() - t_cli
    with open(dump, "w") as f:
        json.dump(spent, f)
atexit.register(_dump)
runpy.run_module("inspektor_gadget_tpu_torch.cli.main", run_name="__main__", alter_sys=True)
"""
HIST_SCHEDULE = "1s@2s,1m@inf"  # a first horizon far shorter than the run: every window ages
EPOCH_RE = re.compile(r"^— sketch epoch (\d+): events=([\d,]+) distinct≈([\d,]+) "
                      r"entropy=([\d.]+)b drops=(\d+)$")


def _metric(snap: dict, name: str, gadget: str = "trace/exec") -> float:
    return float(snap.get(f'{name}{{gadget="{gadget}"}}', 0.0))


def gadget_run(device: str, batches: int, batch: int, *, ops: dict | None = None,
               harvest_every: int = 0, harvest_at: list[int] | None = None,
               seed: str = "7", source: str = "pysynthetic", rate: str = "1e9",
               sketch: bool = True, rows: list | None = None,
               keep_stream: bool = False, gadget: str = "exec",
               category: str = "trace", vocab: str = "2000") -> dict:
    """``<category>/<gadget>`` (trace/exec by default) through the port's
    `LocalRuntime`: the `source`
    (pysynthetic by default: `seed` 7, `vocab` 2000, zipf 1.2, batches of
    `batch` paced at `rate` events/s), the sketch plane with GADGET_SKETCH
    and a harvest interval of 1h (so the only harvest is post_gadget_run's,
    unless the batch callback harvests every `harvest_every` batches, or
    once after batch k for each k in `harvest_at`; no sketch plane without
    `sketch`), the context cancelled from the batch
    callback after `batches` batches. `ops` maps operator names to more
    param values (``tpusketch``'s on top of GADGET_SKETCH); `rows`
    collects the decoded rows, and `keep_stream` each batch's mntns and
    key-hash lanes. Returns the summaries, the alert transitions, the
    run's seconds and its harvest ms (``ig_tpusketch_harvest_seconds``),
    the events of each batch the gadget handed on, the event kinds its
    batches carried, the source's popped, filtered and dropped
    events (``ig_source_events_*``) and the run's result (the bytes of a
    result gadget)."""
    from inspektor_gadget_tpu_torch import all_gadgets  # noqa: F401 — registers everything
    from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
    from inspektor_gadget_tpu_torch.operators import get as get_op
    from inspektor_gadget_tpu_torch.operators.tpusketch import live_instances
    from inspektor_gadget_tpu_torch.params import Collection
    from inspektor_gadget_tpu_torch.runtime import LocalRuntime
    from inspektor_gadget_tpu_torch.telemetry import snapshot
    desc = get(category, gadget)
    gp = desc.params().to_params()
    for k, v in {"source": source, "seed": seed, "vocab": vocab, "zipf": "1.2",
                 "batch-size": str(batch), "rate": rate}.items():
        gp.set(k, v)
    ops = dict(ops or {})
    if sketch:
        ops["tpusketch"] = {"enable": "true", **GADGET_SKETCH, "harvest-interval": "1h",
                            **ops.get("tpusketch", {})}
    col = Collection()
    for name, values in ops.items():
        col[f"operator.{name}."] = get_op(name).instance_params().to_params()
        for k, v in values.items():
            col[f"operator.{name}."].set(k, v)
    summaries: list = []
    alerts: list[dict] = []
    ctx = GadgetContext(desc, gadget_params=gp, operator_params=col,
                        extra={"on_sketch_summary": summaries.append,
                               "on_alert_event": alerts.append}, device=device)
    counts: list[int] = []
    kinds: set[int] = set()
    stream: list[tuple[np.ndarray, np.ndarray]] = []

    def on_batch(b) -> None:
        counts.append(b.count)
        kinds.update(np.unique(b.cols["kind"][:b.count]).tolist())
        if keep_stream:
            stream.append((b.cols["mntns"][:b.count].copy(), b.cols["key_hash"][:b.count].copy()))
        times = (int(len(counts) % harvest_every == 0) if harvest_every
                 else (harvest_at or []).count(len(counts)))
        if times:
            (inst,) = [i for i in live_instances() if i.ctx.run_id == ctx.run_id]
            for _ in range(times):
                inst.harvest()
        if len(counts) == batches:
            ctx.cancel()

    before = snapshot()
    t0 = time.perf_counter()
    res = LocalRuntime().run_gadget(ctx, on_batch=on_batch,
                                    on_event=rows.append if rows is not None else None)["local"]
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    require(res.error is None, f"gadget run on {device}: {res.error}")
    timed = batches // harvest_every if harvest_every else len(harvest_at or [])
    harvests = timed + 1 if sketch else 0
    require(len(counts) == batches and len(summaries) == harvests,
            f"gadget run on {device}: {len(counts)} batches, {len(summaries)} harvests")
    after = snapshot()

    def delta(name: str) -> float:
        return (_metric(after, name, f"{category}/{gadget}")
                - _metric(before, name, f"{category}/{gadget}"))

    h_n, h_s = (delta("ig_tpusketch_harvest_seconds_count"),
                delta("ig_tpusketch_harvest_seconds_sum"))
    return {"summary": summaries[-1] if summaries else None, "summaries": summaries,
            "alerts": alerts, "seconds": secs, "ev_per_s": sum(counts) / secs,
            "harvest_ms": h_s / max(h_n, 1) * 1e3, "counts": counts, "stream": stream,
            "kinds": kinds, "result": res.result,
            "popped": delta("ig_source_events_total"),
            "filtered": delta("ig_source_events_filtered_total"),
            "dropped": delta("ig_source_events_dropped_total")}


def cli_run(device: str, batch: int, seconds: int, dump: Path, sketch: dict,
            extra: tuple[str, ...] = (), rate: str = "30000000") -> dict:
    """``trace exec`` of the port's CLI as a subprocess on the native
    synthetic source at a rate above what its capture thread makes, the
    display filtered to nothing (``-F uid:99``; the synthetic uids are
    0-3) so only the sketch summaries print. Returns its sketch epochs
    (each with its heavy-hitter lines), the run span's seconds, K2's
    launches and the metrics of the run; the tracer's ring is sized to
    keep every span of the run, and the ``!! alert`` lines it printed.
    `extra` flags go after the sketch's."""
    args = ["trace", "exec", "--device", device, "--source", "synthetic", "--rate", rate,
            "--vocab", "2000", "--batch-size", str(batch), "--timeout", str(seconds),
            "-F", "uid:99", "--tpusketch-enable", "true", "--tpusketch-harvest-interval", "1s"]
    for k, v in sketch.items():
        args += [f"--tpusketch-{k}", v]
    args += list(extra)
    dump.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_DRIVER, str(dump), *args],
                          capture_output=True, text=True, timeout=seconds + 170,
                          cwd=Path(__file__).resolve().parent,
                          env=dict(os.environ, IG_TRACE_CAPACITY="65536"))
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"CLI run exited {proc.returncode}: {proc.stderr[-2000:]}")
    epochs: list[dict] = []
    for line in proc.stdout.splitlines():
        m = EPOCH_RE.match(line)
        if m:
            epochs.append({"epoch": int(m[1]), "events": int(m[2].replace(",", "")),
                           "drops": int(m[5]), "heavy_hitters": 0})
        elif epochs and line.startswith("  ") and not line.startswith("  anomaly"):
            epochs[-1]["heavy_hitters"] += 1
    info = json.loads(dump.read_text())
    (run,) = info["runs"]
    m = info["metrics"]
    starts = info["batch_starts"]
    steps = _metric(m, "ig_tpusketch_steps_total")
    require(0 < len(starts) == steps, f"CLI run: {len(starts)} batch spans for {steps} steps")
    return {"epochs": epochs, "run_s": run["duration"], "process_s": wall,
            "alert_lines": [ln for ln in proc.stdout.splitlines() if ln.startswith("!! alert")],
            "setup_s": min(starts) - run["start"],
            "batches_s": run["start"] + run["duration"] - min(starts),
            "k2_launches": info["k2_launches"],
            "steps": steps,
            "source_events": _metric(m, "ig_source_events_total"),
            "source_drops": _metric(m, "ig_source_events_dropped_total"),
            "harvests": _metric(m, "ig_tpusketch_harvest_seconds_count"),
            "harvest_ms": _metric(m, "ig_tpusketch_harvest_seconds_sum")
            / max(_metric(m, "ig_tpusketch_harvest_seconds_count"), 1) * 1e3,
            "update_ms": _metric(m, "ig_tpusketch_update_seconds_sum")
            / max(_metric(m, "ig_tpusketch_update_seconds_count"), 1) * 1e3,
            "h2d_ms": _metric(m, "ig_tpusketch_h2d_seconds_sum")
            / max(_metric(m, "ig_tpusketch_h2d_seconds_count"), 1) * 1e3}


def history_route(device: str, batch: int, seconds: int, sketch: dict, root: Path,
                  no_history_ev_per_s: float) -> dict:
    """Phase 5e(b): `cli_run` with the history plane on (a window a
    second into a store under `root`, STANDING_QUERIES), then on that
    store ``query`` and ``history tiers`` (two subprocesses at once), and
    in one more subprocess (`history_steps`), in turn: ``history
    compact`` (HIST_SCHEDULE, so every window ages and merges), the query
    again, ``history archive`` at the final level, the query a third
    time rehydrating from the archive. Holds
    the first answer's events to the listed windows' sum and the run's
    last summary, the compacted and rehydrated answers to the first (events,
    distinct, entropy, heavy hitters) and logs each step's times. Runs on
    the CPU too, at small sizes."""
    from inspektor_gadget_tpu_torch.history import HISTORY
    hist_cli, arch_cli = root / "chip_smoke_cli_hist", root / "chip_smoke_cli_archive"
    for d in (hist_cli, arch_cli):
        shutil.rmtree(d, ignore_errors=True)
    hcli = cli_run(device, batch, seconds, root / "chip_smoke_cli_hist.json", sketch, extra=(
        "--tpusketch-history", "true", "--tpusketch-history-interval", "1s",
        "--tpusketch-history-dir", str(hist_cli),
        "--tpusketch-standing-queries", json.dumps(STANDING_QUERIES)))
    hep = hcli["epochs"]
    require(len(hep) >= 5 and all(e["heavy_hitters"] > 0 for e in hep),
            f"CLI history run: {len(hep)} sketch epochs")
    hcli["ev_per_s"] = hep[-1]["events"] / hcli["run_s"]
    listed = HISTORY.list_windows(base_dir=str(hist_cli))
    dumpq = root / "chip_smoke_history_cli.json"
    q_args = ["query", "--history", str(hist_cli), "--gadget", "trace/exec", "-o", "json"]
    # query and tiers only read the store: they run at once
    hsteps = history_clis({"query": q_args,
                           "tiers": ["history", "tiers", "--history", str(hist_cli), "-o",
                                     "json"]}, root, "chip_smoke_history_cli")
    # the four that write or read what the one before wrote: in turn, in one
    # process (one import of torch for the four)
    later, proc_times = history_steps({
        "compact": ["history", "compact", "--history", str(hist_cli), "--schedule",
                    HIST_SCHEDULE, "-o", "json"],
        "query compacted": q_args,
        "archive": ["history", "archive", "--history", str(hist_cli), "--archive-dir",
                    str(arch_cli), "--schedule", HIST_SCHEDULE, "-o", "json"],
        "query rehydrated": q_args + ["--archive-dir", str(arch_cli)]}, dumpq)
    hsteps.update(later)
    first, compacted, rehydrated = (json.loads(hsteps[k]["stdout"]) for k in (
        "query", "query compacted", "query rehydrated"))
    require(first["windows"] == len(listed) > 1 and first["events"] == sum(
        h["events"] for h in listed) == hep[-1]["events"],
            f"CLI query: {first['windows']} windows, {first['events']} events; the store lists "
            f"{len(listed)} windows of {sum(h['events'] for h in listed)} events, the run's last "
            f"summary {hep[-1]['events']}")
    tiers = json.loads(hsteps["tiers"]["stdout"])["tiers"]
    require(tiers["levels"]["0"]["windows"] == len(listed), f"history tiers: {tiers['levels']}")
    (cstats,) = json.loads(hsteps["compact"]["stdout"])
    require(cstats["source_windows"] == len(listed) and cstats["super_windows"] > 0,
            f"history compact: {cstats}")
    (astats,) = json.loads(hsteps["archive"]["stdout"])
    require(astats["windows"] == cstats["super_windows"] == compacted["windows"]
            == compacted["compacted_windows"] == rehydrated["windows"]
            and HISTORY.list_windows(base_dir=str(hist_cli)) == [],
            f"history archive: {astats}; compacted query {compacted['windows']} windows, "
            f"rehydrated {rehydrated['windows']}")
    for name, ans in (("compacted", compacted), ("rehydrated", rehydrated)):
        for k in ("events", "distinct", "entropy_bits", "heavy_hitters"):
            require(ans[k] == first[k], f"CLI query, {name}: {k} {ans[k]} != {first[k]}")
    log(f"[history] (5e b) CLI trace exec with --tpusketch-history true, a window a second, "
        f"standing queries: {hcli['ev_per_s']:.0f} events/s end to end over the run span "
        f"({hcli['run_s']:.2f} s, set-up {hcli['setup_s']:.2f} s), beside 5d(b)'s "
        f"{no_history_ev_per_s:.0f} without history in this call; {len(listed)} windows sealed, "
        f"{hcli['harvests']:.0f} harvests of {hcli['harvest_ms']:.1f} ms, last summary "
        f"{hep[-1]['events']} events, drops {hep[-1]['drops']}; K2 {hcli['k2_launches']} "
        f"launches over {hcli['steps']:.0f} steps")
    log(f"[history] (5e b) query: {first['windows']} windows, events {first['events']} (= the "
        f"listed windows' sum = the last summary's), distinct ~{first['distinct']:.0f}; compact "
        f"({HIST_SCHEDULE}): {cstats['source_windows']} windows -> {cstats['super_windows']} "
        f"super-windows, {cstats['bytes_reclaimed']} bytes reclaimed; archive: "
        f"{astats['segments']} segment(s), {astats['bytes']} bytes; the compacted and the "
        f"rehydrated answers equal the first in events, distinct, entropy and heavy hitters")
    for name, st in hsteps.items():
        timed = {k: v for k, v in st.items() if k.endswith("_s") and k != "wall_s"}
        where = ("of process" if name not in later
                 else "in the process of the four below (after its imports)")
        log(f"[history] (5e b) {name}: exit 0, {st['wall_s']:.2f} s {where}; " + ", ".join(
            f"{k[:-2]} {v * 1e3:.1f} ms" for k, v in timed.items()))
    log(f"[history] (5e b) compact, query, archive and query in one process: "
        f"{proc_times['wall_s']:.2f} s of process, torch's import "
        f"{proc_times['torch_import_s'] * 1e3:.1f} ms, the CLI's "
        f"{proc_times['cli_import_s'] * 1e3:.1f} ms")
    return {"cli_run": hcli, "windows": len(listed),
                         "steps": {k: {x: y for x, y in v.items() if x != "stdout"}
                                   for k, v in hsteps.items()},
                         "one_process": proc_times,
                         "compact": cstats, "archive": astats,
                         "answer": {k: first[k] for k in ("windows", "events", "distinct",
                                                          "entropy_bits")}}



def history_steps(steps: dict[str, list[str]], dump: Path) -> tuple[dict, dict]:
    """Several ig-tpu-torch subcommands in turn in ONE subprocess through
    HISTORY_SCRIPT ``--steps`` (one import of torch and of the CLI for
    all): each must exit 0. Returns each step's standard output and
    times by name (``wall_s`` its own time in the process), and the
    process's (``wall_s``, torch's and the CLI's import)."""
    dump.unlink(missing_ok=True)
    (proc, wall), = run_at_once({"": [sys.executable, "-c", HISTORY_SCRIPT, str(dump),
                                      "--steps", json.dumps(list(steps.values()))]},
                                timeout=300).values()
    require(proc is not None and proc.returncode == 0,
            f"ig-tpu-torch {' / '.join(' '.join(a[:2]) for a in steps.values())}: "
            + (f"exited {proc.returncode}: {proc.stderr[-2000:]}" if proc is not None
               else "no exit in 300 s"))
    got = json.loads(dump.read_text())
    out = {name: {"stdout": st.pop("stdout"), "wall_s": st.pop("cli_s"), **st}
           for name, st in zip(steps, got.pop("steps"))}
    for st in out.values():
        st.pop("rc")
    return out, {"wall_s": wall, **got}


def run_at_once(cmds: dict[str, list[str]], timeout: float) -> dict[str, tuple]:
    """Each command a subprocess from the repo's root, all started
    together. Returns by name (the CompletedProcess, or None if it ran past
    `timeout` and was killed; its wall time from its start to its own
    exit)."""
    cwd = Path(__file__).resolve().parent
    done: dict = {}

    def run(name: str, cmd: list[str]) -> None:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=cwd)
        except subprocess.TimeoutExpired:
            proc = None
        done[name] = (proc, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=item, daemon=True) for item in cmds.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {name: done[name] for name in cmds}


def history_clis(steps: dict[str, list[str]], root: Path, stem: str = "step") -> dict:
    """`history_cli` of each step at once, each a subprocess of its own
    (steps that read the same store or journal and write nothing another
    reads): every one must exit 0. Returns each one's result by name."""
    dumps = {name: root / f"{stem}-{i}.json" for i, name in enumerate(steps)}
    for dump in dumps.values():
        dump.unlink(missing_ok=True)
    done = run_at_once({name: [sys.executable, "-c", HISTORY_SCRIPT, str(dumps[name]), *args]
                        for name, args in steps.items()}, timeout=300)
    out = {}
    for name, args in steps.items():
        proc, wall = done[name]
        require(proc is not None and proc.returncode == 0,
                f"ig-tpu-torch {' '.join(args[:2])}: "
                + (f"exited {proc.returncode}: {proc.stderr[-2000:]}" if proc is not None
                   else "no exit in 300 s"))
        out[name] = {"stdout": proc.stdout, "wall_s": wall, **json.loads(dumps[name].read_text())}
    return out


# phase 5f: capture, alerts and replay. Rules on sketch fields only (the
# timed pipeline fields cannot replay identically); `busy` fires once the
# run passes a quarter of its events (2**20 on the card) and resolves when
# the run ends, so the engine's end-of-run resolve must reach the journal


def capture_rules(events: int) -> list[dict]:
    return [
        {"id": "busy", "kind": "threshold", "field": "events", "op": ">",
         "threshold": events // 4, "severity": "info"},
        {"id": "entropy", "kind": "entropy_jump", "threshold": 0.05, "window": 3},
        {"id": "distinct", "kind": "cardinality_spike", "factor": 1.5, "window": 3},
        {"id": "churn", "kind": "heavy_hitter_churn", "threshold": 0.3},
        {"id": "p99", "kind": "quantile_shift", "field": "p99", "factor": 1.5, "window": 3},
    ]


CAPTURE_ROUTE_BATCHES = 16  # 5f(a)'s runs and replays: 32 until 5k came
CAPTURE_HARVEST_EVERY = 4
CAPTURE_CLI_SECONDS = 4  # 5 s until 5j came
CAPTURE_HISTORY = ("--tpusketch-history", "true", "--tpusketch-history-interval", "0")


def _transitions(alerts: list[dict]) -> list[tuple]:
    return [(a["rule"], a.get("key", ""), a["transition"], a.get("epoch", 0)) for a in alerts]


def capture_run(device: str, batches: int, batch: int, root: Path, rules: Path, *,
                capture: bool) -> dict:
    """`gadget_run` with the history plane sealing a window a harvest
    into ``root/hist-live`` (``root/hist-plain`` without capture), the
    alert rules of `rules`, a harvest every CAPTURE_HARVEST_EVERY
    batches, and with `capture` the capture operator journaling into
    ``root/journal`` with unlimited retention. Adds the run's journal and
    its sealed windows' digests to `gadget_run`'s result."""
    from inspektor_gadget_tpu_torch.capture import iter_journals
    from inspektor_gadget_tpu_torch.history import HISTORY
    hist, journal = root / ("hist-live" if capture else "hist-plain"), root / "journal"
    shutil.rmtree(hist, ignore_errors=True)
    if capture:
        shutil.rmtree(journal, ignore_errors=True)
    out = gadget_run(device, batches, batch, harvest_every=CAPTURE_HARVEST_EVERY, ops={
        "tpusketch": {"history": "true", "history-interval": "0", "history-dir": str(hist)},
        "alerts": {"rules-file": str(rules), "log": "false"},
        "capture": {"dir": str(journal) if capture else "", "retention-bytes": "0"}})
    out["windows"] = [r["digest"] for r in HISTORY.list_windows(base_dir=str(hist),
                                                                 gadget="trace/exec")]
    if capture:
        (out["journal"],) = iter_journals(str(journal))
    return out


def replay_run(jpath: str, device: str, hist: Path) -> dict:
    """`replay_journal` of `jpath` on `device`, its resealed windows into
    `hist`. Returns the `ReplayResult`, the harvested `SketchSummary`s
    (taken where the replay turns each into its digest dict), its seconds
    and events/s and the windows' digests."""
    from inspektor_gadget_tpu_torch.capture import replay as RP
    from inspektor_gadget_tpu_torch.history import HISTORY
    shutil.rmtree(hist, ignore_errors=True)
    summaries: list = []
    to_dict = RP.summary_to_dict

    def keep(summary):
        summaries.append(summary)
        return to_dict(summary)

    RP.summary_to_dict = keep
    t0 = time.perf_counter()
    try:
        res = RP.replay_journal(jpath, device=device,
                                param_overrides={"operator.tpusketch.history-dir": str(hist)})
    finally:
        RP.summary_to_dict = to_dict
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"result": res, "summaries": summaries, "seconds": secs,
            "ev_per_s": res.events / secs,
            "windows": [r["digest"] for r in HISTORY.list_windows(base_dir=str(hist),
                                                                   gadget="trace/exec")]}


def capture_route(device: str, batches: int, batch: int, root: Path) -> dict:
    """Phase 5f (a): `capture_run` with the capture operator, the same
    run without it, then the journal replayed twice on `device` and once
    on the CPU. Each replay on `device` must reproduce the recording's
    digests (ae scores included) and transitions, launch K2 once a
    replayed batch and reseal the recorded run's windows; the CPU
    replay's summaries must equal the card's (`compare_summaries`, ae
    within 5%), with the same transitions and windows. The recording
    must hold a transition and the run-end resolve. Runs on the CPU too,
    at small sizes."""
    from inspektor_gadget_tpu_torch.capture import JournalReader
    from inspektor_gadget_tpu_torch.capture.journal import dir_stats
    root.mkdir(parents=True, exist_ok=True)
    rules = root / "rules.json"
    rules.write_text(json.dumps(capture_rules(batches * batch)))
    on_card = device == "cuda"
    reset_launches()
    rec = capture_run(device, batches, batch, root, rules, capture=True)
    rec_k2 = read_launches()["K2"]
    require(not on_card or rec_k2 == batches, f"recorded run: K2 {rec_k2} launches")
    plain = capture_run(device, batches, batch, root, rules, capture=False)
    jpath = rec["journal"]
    reader = JournalReader(jpath)
    stats = reader.stats()
    _segments, jbytes = dir_stats(jpath)
    raw = sum(len(p) for _h, p in reader.records(types=(4,)))  # EV_BATCH_NPZ payloads
    replays, k2 = [], rec_k2
    for i, dev in enumerate((device, device, "cpu")):
        reset_launches()
        rp = replay_run(jpath, dev, root / f"hist-replay{i}")
        rp["k2_launches"] = read_launches()["K2"]
        replays.append(rp)
        if dev == device and on_card:
            k2 += rp["k2_launches"]
    card1, card2, cpu = replays
    busy = [a["transition"] for a in card1["result"].recorded_alerts if a["rule"] == "busy"]
    require(busy == ["pending", "firing", "resolved"],
            f"recorded `busy` transitions {busy}: the run-end resolve must be journaled")
    for n, rp in enumerate((card1, card2), 1):
        r = rp["result"]
        require(r.digests_match and r.alerts_match and not r.losses,
                f"replay {n} on {device}: digests_match {r.digests_match}, alerts_match "
                f"{r.alerts_match}, losses {r.losses}")
        require(r.batches == batches and (not on_card or rp["k2_launches"] == r.batches),
                f"replay {n} on {device}: {r.batches} batches, K2 {rp['k2_launches']} launches")
        require(rp["windows"] == rec["windows"] and len(rec["windows"]) > 1,
                f"replay {n} on {device}: resealed windows differ from the recorded run's")
    require(_transitions(card1["result"].recorded_alerts) == _transitions(rec["alerts"]),
            "the journal's transitions differ from the run's")
    gap = 0.0
    require(len(cpu["summaries"]) == len(card1["summaries"]) > 1, "CPU replay: harvests differ")
    for j, (g, w) in enumerate(zip(card1["summaries"], cpu["summaries"])):
        gap = max(gap, compare_summaries(g, w, f"replay, harvest {j}, {device} vs CPU",
                                         anomaly_rel=5e-2))
    require(_transitions(cpu["result"].alerts) == _transitions(card1["result"].alerts),
            "CPU replay: transitions differ")
    require(cpu["windows"] == card1["windows"], "CPU replay: resealed windows differ")
    info = {"recorded_ev_per_s": rec["ev_per_s"], "recorded_s": rec["seconds"],
            "no_capture_ev_per_s": plain["ev_per_s"], "no_capture_s": plain["seconds"],
            "journal_bytes": jbytes, "journal_bytes_per_batch": jbytes / batches,
            "raw_npz_bytes_per_batch": raw / batches, "records": stats["by_type"],
            "transitions": len(rec["alerts"]), "harvests": len(card1["summaries"]),
            "windows": len(rec["windows"]), "k2_launches": k2, "ae_rel_gap": gap,
            "journal": jpath,
            "replays": [{"device": d, "seconds": rp["seconds"], "ev_per_s": rp["ev_per_s"],
                         "k2_launches": rp["k2_launches"],
                         "digests_match": rp["result"].digests_match,
                         "alerts_match": rp["result"].alerts_match}
                        for d, rp in zip((device, device, "cpu"), replays)]}
    log(f"[capture] (5f a) LocalRuntime trace/exec recorded ({batches} x {batch} events, every "
        f"plane of 5d, history a window a harvest, 5 rules): "
        f"{rec['ev_per_s']:.0f} events/s ({rec['seconds']:.2f} s), the same run without capture "
        f"{plain['ev_per_s']:.0f} ({plain['seconds']:.2f} s); journal {jbytes} bytes, "
        f"{jbytes / batches:.0f} a batch ({raw / batches:.0f} of npz before zlib), records "
        f"{stats['by_type']}; {len(rec['alerts'])} transitions, {len(rec['windows'])} windows")
    log(f"[capture] (5f a) replays: " + "; ".join(
        f"{d} {rp['ev_per_s']:.0f} events/s ({rp['seconds']:.2f} s, K2 {rp['k2_launches']}, "
        f"digests_match {rp['result'].digests_match}, alerts_match {rp['result'].alerts_match})"
        for d, rp in zip((device, device, "cpu"), replays))
        + f"; the CPU's summaries equal the card's (ae within {gap:.3g} of a score), its "
        f"transitions and windows the same; `busy` {busy}")
    return info


def capture_cli(device: str, batch: int, root: Path, no_capture_ev_per_s: float) -> dict:
    """Phase 5f (b): `cli_run` at 2M events/s asked for CAPTURE_CLI_SECONDS
    with GADGET_SKETCH, a window a harvest, ``--capture-dir`` (unlimited
    retention) and ``--alerts-rules-file``; then ``record inspect``,
    ``replay --verify -o json``, ``alerts rules`` and ``alerts test
    --journal``, each a subprocess through `history_clis`, all four at
    once, that must exit 0. The replay must report ``digests_match`` and ``alerts_match``, over
    every recorded batch and harvest."""
    rules, journal, hist = root / "rules.json", root / "cli-journal", root / "cli-hist"
    for d in (journal, hist):
        shutil.rmtree(d, ignore_errors=True)
    run = cli_run(device, batch, CAPTURE_CLI_SECONDS, root / "cli-run.json", GADGET_SKETCH,
                  extra=(*CAPTURE_HISTORY, "--tpusketch-history-dir", str(hist),
                         "--capture-dir", str(journal), "--capture-retention-bytes", "0",
                         "--alerts-rules-file", str(rules)), rate="2000000")
    ep = run["epochs"]
    require(len(ep) >= 2 and run["alert_lines"], f"CLI capture run: {len(ep)} sketch epochs, "
                                                 f"{len(run['alert_lines'])} alert lines")
    run["ev_per_s"] = ep[-1]["events"] / run["run_s"]
    # the four steps read the journal and the rule file: they run at once
    steps = history_clis({
        "record inspect": ["record", "inspect", str(journal)],
        "replay --verify": ["replay", str(journal), "--verify", "-o", "json", "--device", device],
        "alerts rules": ["alerts", "rules", "--file", str(rules)],
        "alerts test": ["alerts", "test", "--file", str(rules), "--journal", str(journal)]},
        root, "cli-step")
    (jstats,) = json.loads(steps["record inspect"]["stdout"])["journals"].values()
    (rep,) = json.loads(steps["replay --verify"]["stdout"])
    require(rep["digests_match"] and rep["alerts_match"] and rep["harvests"] == len(ep)
            and rep["batches"] == jstats["by_type"]["4"] == run["steps"],
            f"CLI replay: {json.dumps({k: rep[k] for k in ('batches', 'harvests', 'alerts')})}, "
            f"digests_match {rep['digests_match']}, alerts_match {rep['alerts_match']}; the run "
            f"printed {len(ep)} epochs over {run['steps']:.0f} steps")
    require("5 rule(s) ok" in steps["alerts rules"]["stdout"],
            "alerts rules: the rule file did not validate")
    require(f"1 journal(s), {len(ep)} summaries" in steps["alerts test"]["stdout"],
            f"alerts test: {steps['alerts test']['stdout'][-300:]}")
    log(f"[capture] (5f b) CLI trace exec --rate 2000000 --timeout {CAPTURE_CLI_SECONDS} "
        f"--capture-dir --alerts-rules-file: exit 0, {run['ev_per_s']:.0f} events/s over the run "
        f"span ({run['run_s']:.2f} s, set-up {run['setup_s']:.2f} s, {run['process_s']:.1f} s of "
        f"process; 5d(b) without capture {no_capture_ev_per_s:.0f} at 30M asked), {len(ep)} "
        f"epochs, {len(run['alert_lines'])} alert lines, drops {ep[-1]['drops']}, K2 "
        f"{run['k2_launches']} launches; journal {jstats['records']} records, replay "
        f"{rep['batches']} batches, {rep['harvests']} harvests, {rep['alerts']} transitions, "
        f"digests_match and alerts_match true")
    for name, st in steps.items():
        log(f"[capture] (5f b) {name}: exit 0, {st['wall_s']:.2f} s of process, torch's import "
            f"{st['torch_import_s']:.2f} s, the command {st['cli_s']:.2f} s")
    return {"cli_run": {k: v for k, v in run.items() if k != "alert_lines"},
            "alert_lines": len(run["alert_lines"]),
            "steps": {k: {x: y for x, y in v.items() if x != "stdout"} for k, v in steps.items()},
            "replay": rep}


# phase 5f: the harvest's entropy across devices. With the anomaly plane
# off nothing learned enters a summary, so a journal recorded on the card
# replays on the CPU digest for digest only if every field the digest
# hashes (events, distinct, entropy, heavy hitters) is bit for bit the
# card's. The journal is kept under build/ for the JAX package's replay.
ENTROPY_BATCHES = 4
ENTROPY_JOURNAL = "chip_smoke_entropy_journal"


def entropy_journal(device: str, batch: int, root: Path, keep: Path) -> dict:
    """5d(a)'s run for ENTROPY_BATCHES batches with ``anomaly-model`` off
    and a harvest every batch, recorded by the capture operator on
    `device`, then replayed on the CPU. Every CPU harvest's
    `entropy_bits` and `distinct` must equal the recorded ones exactly,
    so the replay's digests match. The journal is copied to `keep`."""
    from inspektor_gadget_tpu_torch.capture import iter_journals
    journal = root / "entropy-journal"
    shutil.rmtree(journal, ignore_errors=True)
    rec = gadget_run(device, ENTROPY_BATCHES, batch, harvest_every=1, ops={
        "tpusketch": {"anomaly": "false"},
        "capture": {"dir": str(journal), "retention-bytes": "0"}})
    (jpath,) = iter_journals(str(journal))
    cpu = replay_run(jpath, "cpu", root / "entropy-hist")
    got, want = cpu["summaries"], rec["summaries"]
    require(len(got) == len(want) == ENTROPY_BATCHES + 1,
            f"entropy journal: {len(got)} replayed harvests, {len(want)} recorded")
    ent = [(g.entropy_bits, w.entropy_bits) for g, w in zip(got, want)]
    dist = [(g.distinct, w.distinct) for g, w in zip(got, want)]
    require(all(a == b for a, b in ent),
            f"entropy journal: the CPU replay's entropy differs from the card's: {ent}")
    require(all(a == b for a, b in dist) and cpu["result"].digests_match,
            f"entropy journal: the CPU replay's distinct differs from the card's: {dist}")
    shutil.rmtree(keep, ignore_errors=True)
    shutil.copytree(jpath, keep)
    r = cpu["result"]
    info = {"harvests": len(want), "digests_match": r.digests_match,
            "alerts_match": r.alerts_match,
            "journal": str(keep), "entropy_bits": [w for _g, w in ent]}
    log(f"[capture] (5f) entropy across devices: {len(want)} harvests recorded on the {device} "
        f"with anomaly-model off, replayed on the CPU: entropy_bits and distinct equal bit "
        f"for bit in every harvest, digests_match {r.digests_match}; journal kept at {keep}")
    return info


# phase 5g: container scoping. The localmanager's collection holds one
# container for each of the synthetic sources' 64 mount namespaces
# (sources/synthetic.py, native/sources.cc: 4026531840 + k); every fourth
# is in namespace team-a, which the kubemanager selector picks
MNTNS0 = 4026531840
SCOPED_NAMESPACE = "team-a"
SCOPED_BATCHES = 32
SCOPED_NATIVE_BATCHES = 16
SCOPED_NATIVE_RATE = "1000000"  # the ring (2**20) never fills: no drops to account
BLACK_BOX_COMM = "igbb-exec"  # a comm no other process has: the container's name


def fleet(container_cls) -> list:
    return [container_cls(id=f"smoke-{k:02d}", name=f"ctr-{k:02d}", pod=f"pod-{k // 2:02d}",
                          namespace=f"team-{'abcd'[k % 4]}", mntns=MNTNS0 + k,
                          labels={"app": f"app-{k % 3}"}, runtime="fake")
            for k in range(64)]


def selected_mntns() -> np.ndarray:
    return np.arange(MNTNS0, MNTNS0 + 64, 4, dtype=np.uint64)


def pysynthetic_scoped_counts(batches: int, batch: int) -> list[int]:
    """Events of the selected namespaces in each batch of 5d(a)'s seeded
    pysynthetic stream (seed 7, vocab 2000, zipf 1.2), rebuilt here,
    batches the selector empties skipped."""
    from inspektor_gadget_tpu_torch.sources import PySyntheticSource
    src = PySyntheticSource(kind=1, seed=7, vocab=2000, zipf_s=1.2, batch_size=batch)
    out: list[int] = []
    while len(out) < batches:
        n = int(np.isin(src.generate().cols["mntns"][:batch], selected_mntns()).sum())
        if n:
            out.append(n)
    return out


def native_accounting(stream: list, popped: int, filtered: int, seed: int) -> dict:
    """Hold a native synthetic run's capture-side filter to the seeded
    stream (`NativeCapture.generate`, the same seed): the popped events
    must be the stream's first `popped` selected events, in order, and
    the capture must have stopped after the `popped`-th selected event
    and before the (`filtered` + 1)-th unselected one (it filtered
    exactly the unselected events it made). Returns the bracket of the
    events left in the ring at the stop."""
    from inspektor_gadget_tpu_torch.sources import bridge
    got_m = np.concatenate([m for m, _k in stream])
    got_k = np.concatenate([k for _m, k in stream])
    need = popped + filtered + (1 << 20)
    src = bridge.NativeCapture(bridge.SRC_SYNTH_EXEC, seed=seed, vocab=2000)
    try:
        chunks = [src.generate(1 << 20) for _ in range(-(-need // (1 << 20)))]
    finally:
        src.close()
    mntns = np.concatenate([c.cols["mntns"][:c.count] for c in chunks])
    keys = np.concatenate([c.cols["key_hash"][:c.count] for c in chunks])
    sel = np.isin(mntns, selected_mntns())
    pos = np.flatnonzero(sel)
    require(len(pos) >= popped and np.array_equal(mntns[pos[:popped]], got_m)
            and np.array_equal(keys[pos[:popped]], got_k),
            "native scoped run: the popped events are not the seeded stream's first selected ones")
    uns = np.flatnonzero(~sel)
    after_last = pos[popped - 1]
    next_unselected = uns[filtered] if filtered < len(uns) else len(mntns)
    require(after_last < next_unselected and int((~sel[:after_last]).sum()) <= filtered,
            f"native scoped run: {filtered} filtered does not close with {popped} popped")
    last_unselected = uns[filtered - 1] if filtered else 0
    left = (max(0, int(sel[:last_unselected + 1].sum()) - popped),
            int(sel[:next_unselected].sum()) - popped)
    return {"left_in_ring": left}


def scoped_route(device: str, batch: int, unscoped_ev_per_s: float) -> dict:
    """Phase 5g(a): the localmanager's collection seeded with `fleet`,
    then (1) 5d(a)'s run scoped by ``operator.kubemanager.namespace``
    on `device` and on the CPU: equal summaries, `events` equal to the
    selected share of the stream rebuilt from the seed, K2 once a
    non-empty batch; (2) the same on the native synthetic source (the
    filter in C++, before the ring) with the history plane's slices on:
    events = popped, the capture's filtered count closing the stream
    (`native_accounting`), every ``mntns:N`` slice inside the selection;
    (3) a decoded-rows run, the sketch plane off: every row named as
    its seeded container. The seeded containers are removed at the end.
    Runs on the CPU too, at small sizes (`device` "cpu")."""
    from inspektor_gadget_tpu_torch.containers import Container
    from inspektor_gadget_tpu_torch.history import HISTORY, decode_window
    from inspektor_gadget_tpu_torch.operators.operators import ensure_initialized
    lm = ensure_initialized("localmanager")
    seeded = fleet(Container)
    for c in seeded:
        lm.cc.add_container(c)
    kube = {"kubemanager": {"namespace": SCOPED_NAMESPACE}}
    on_card = device == "cuda"
    try:
        # (1) the library route on pysynthetic, then the same run on the CPU
        reset_launches()
        card = gadget_run(device, SCOPED_BATCHES, batch, ops=kube)
        launched = read_launches()
        cpu = gadget_run("cpu", SCOPED_BATCHES, batch, ops=kube)
        want = pysynthetic_scoped_counts(SCOPED_BATCHES, batch)
        gap = compare_summaries(card["summary"], cpu["summary"],
                                f"scoped run, {device} vs CPU", anomaly_rel=5e-2)
        nonempty = sum(1 for n in card["counts"] if n)
        require(card["counts"] == cpu["counts"] == want
                and card["summary"].events == sum(want),
                f"scoped run: batches {card['counts'][:4]}..., events {card['summary'].events}, "
                f"the seeded stream's selected events {sum(want)}")
        require(not on_card or launched == {"K1": 0, "K2": nonempty, "K3": 0},
                f"scoped run launched {launched}, expected K2 {nonempty} (once a non-empty batch)")
        share = 1 - card["summary"].events / card["popped"]
        # (2) the native capture: the filter runs in C++ before the ring
        hist = Path(__file__).resolve().parent / "build" / "chip_smoke_scoped_hist"
        shutil.rmtree(hist, ignore_errors=True)
        reset_launches()
        nat = gadget_run(device, SCOPED_NATIVE_BATCHES, batch, source="synthetic",
                         rate=SCOPED_NATIVE_RATE, keep_stream=True, ops={
                             **kube, "tpusketch": {"history": "true", "history-interval": "0",
                                                   "history-dir": str(hist)}})
        nat_launched = read_launches()
        ns = nat["summary"]
        popped, filtered = int(nat["popped"]), int(nat["filtered"])
        require(ns.events == popped == sum(nat["counts"]) and ns.drops == 0
                and nat["dropped"] == 0 and filtered > 0,
                f"native scoped run: events {ns.events}, popped {popped}, filtered {filtered}, "
                f"drops {ns.drops}/{nat['dropped']}")
        require(not on_card or nat_launched["K2"] == len(nat["counts"]),
                f"native scoped run: K2 {nat_launched['K2']} launches over "
                f"{len(nat['counts'])} batches")
        acct = native_accounting(nat["stream"], popped, filtered, seed=7)
        windows = [decode_window(h, pl) for h, pl in
                   HISTORY.fetch_windows(base_dir=str(hist), gadget="trace/exec")]
        slices = {k: v for w in windows for k, v in w.slices.items() if "|" not in k
                  and k.startswith("mntns:")}
        allowed = {f"mntns:{m}" for m in selected_mntns().tolist()}
        require(windows and slices and set(slices) <= allowed
                and sum(v["events"] for v in slices.values()) == ns.events,
                f"native scoped run: slices {sorted(set(slices) - allowed)[:4]} outside the "
                f"selection, or their events differ from the summary's {ns.events}")
        shutil.rmtree(hist, ignore_errors=True)
        # (3) decoded rows, the sketch plane off: each row names its container
        rows: list = []
        shown = gadget_run(device, 2, batch, sketch=False, rows=rows, ops=kube)
        names = {c.mntns: (c.name, c.pod, c.namespace) for c in seeded}
        bad = [r for r in rows if (r.container, r.pod, r.namespace) != names.get(r.mountnsid)
               or r.node != lm.cc.node_name]
        require(len(rows) == sum(shown["counts"]) > 0 and not bad,
                f"scoped rows: {len(rows)} rows, {len(bad)} not named as their container "
                f"(e.g. {bad[:1]})")
    finally:
        for c in seeded:
            lm.cc.remove_container(c.id)
    info = {"events": card["summary"].events, "popped": card["popped"],
            "filtered_share": share, "batches": len(card["counts"]), "k2_launches": launched["K2"],
            "ev_per_s": card["ev_per_s"], "source_ev_per_s": card["popped"] / card["seconds"],
            "seconds": card["seconds"], "cpu_seconds": cpu["seconds"],
            "unscoped_ev_per_s": unscoped_ev_per_s, "ae_rel_gap": gap,
            "native": {"events": ns.events, "popped": popped, "filtered": filtered,
                       "filtered_share": filtered / (popped + filtered),
                       "batches": len(nat["counts"]), "k2_launches": nat_launched["K2"],
                       "seconds": nat["seconds"], "ev_per_s": nat["ev_per_s"],
                       "slices": len(slices), **acct},
            "rows": len(rows), "rows_seconds": shown["seconds"]}
    log(f"[containers] (5g a) trace/exec scoped by kubemanager namespace={SCOPED_NAMESPACE} "
        f"(16 of 64 seeded containers), pysynthetic seed 7, {len(card['counts'])} x {batch}: "
        f"{card['summary'].events} of {card['popped']:.0f} events kept (the filter drops "
        f"{share:.4f}), equal to the seeded stream's selected events; {device} "
        f"{card['ev_per_s']:.0f} scoped events/s ({info['source_ev_per_s']:.0f} popped/s, "
        f"{card['seconds']:.2f} s), 5d(a) unscoped {unscoped_ev_per_s:.0f} in this run; CPU "
        f"{cpu['seconds']:.2f} s; summaries equal (distinct and entropy bit for bit, ae within {gap:.3g}); "
        f"launches {launched}")
    log(f"[containers] (5g a) native synthetic at {SCOPED_NATIVE_RATE}/s asked, filter in C++: "
        f"{ns.events} events = {popped} popped, {filtered} filtered "
        f"({filtered / (popped + filtered):.4f}), no drops, {len(nat['counts'])} batches, K2 "
        f"{nat_launched['K2']}; the popped events are the seed's first selected ones and the "
        f"filtered count closes the stream ({acct['left_in_ring']} left in the ring at the "
        f"stop); {len(slices)} mntns slices, all selected, their events the summary's")
    log(f"[containers] (5g a) decoded rows, sketch plane off: {len(rows)} rows in "
        f"{shown['seconds']:.2f} s, each named as its seeded container, pod, namespace and "
        f"node {lm.cc.node_name!r}")
    return info


PROBE_EXECS = 10  # execs of the probe's child the proc-exec source must report within 6 s


def host_facts() -> dict:
    """What 5g(b) and later items need of the card's host: the card
    count, whether grpc and google.protobuf import (the CRI client),
    root, a working ``unshare -m``, and whether the proc-exec source
    reports PROBE_EXECS execs of a child shell's within 6 s (a
    short-lived /bin/true exec may come without its comm and parent,
    read from /proc after it exited, so the child's `sleep`s count); and
    the localmanager's procfs scan
    (`ensure_initialized`, its first init in this process)."""
    import importlib
    from inspektor_gadget_tpu_torch import all_gadgets  # noqa: F401 — registers the operators
    from inspektor_gadget_tpu_torch.operators.operators import ensure_initialized
    from inspektor_gadget_tpu_torch.sources import bridge
    facts: dict = {"device_count": torch.cuda.device_count()}
    for mod in ("grpc", "google.protobuf"):
        try:
            importlib.import_module(mod)
            facts[mod] = True
        except ImportError as e:
            facts[mod] = f"no ({e})"
    facts["root"] = os.geteuid() == 0
    unshare = shutil.which("unshare")
    facts["unshare"] = bool(unshare) and subprocess.run(
        [unshare, "-m", "true"], capture_output=True, timeout=30).returncode == 0
    seen = 0
    try:
        src = bridge.NativeCapture(bridge.SRC_PROC_EXEC, batch_size=4096)
        src.start()
        # execs for up to 6 s: where the proc connector is refused, the
        # source falls back to polling /proc only after 2 s of silence
        child = subprocess.Popen(["sh", "-c", "for i in $(seq 1 120); do /bin/true; "
                                              "sleep 0.05; done"])
        deadline = time.perf_counter() + 6.0
        while time.perf_counter() < deadline and seen < PROBE_EXECS:
            b = src.pop()
            seen += int(((b.cols["kind"][:b.count] == 1)
                         & (b.cols["ppid"][:b.count] == child.pid)).sum())
            time.sleep(0.05)
        child.kill()
        child.wait(timeout=30)
        src.stop()
        src.close()
    except (OSError, RuntimeError, ValueError) as e:
        facts["proc_exec_error"] = str(e)
    facts["proc_exec"] = seen >= PROBE_EXECS
    facts["proc_exec_seen"] = seen
    t0 = time.perf_counter()
    lm = ensure_initialized("localmanager")
    facts["procfs_scan_s"] = time.perf_counter() - t0
    facts["procfs_containers"] = len(lm.cc)
    # the trace gadgets' kernel windows (phase 5h(b)) and the 17b gadgets' (5i(b))
    for probe in WINDOW_PROBES:
        facts[probe] = bool(getattr(bridge, probe)())
    facts["kmsg_readable"] = os.access("/dev/kmsg", os.R_OK)
    facts["diskstats"] = os.access("/proc/diskstats", os.R_OK)  # the block-io windows
    facts["cap_net_raw"] = has_capability(13)  # CAP_NET_RAW: the AF_PACKET sniffers
    facts["ptrace"] = ptrace_works(bridge)
    return facts


WINDOW_PROBES = ("fanotify_supported", "audit_supported", "captrace_supported",
                 "fstrace_supported", "sockstate_supported", "sigtrace_supported",
                 "tcpinfo_supported", "blktrace_supported", "perf_supported")


def has_capability(bit: int) -> bool:
    """Whether this process's effective capability set holds `bit`."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("CapEff:"):
                return bool((int(line.split()[1], 16) >> bit) & 1)
    return False


def ptrace_works(bridge) -> bool:
    """Whether the ptrace source traces a spawned ``true`` (a container's
    seccomp profile may refuse ptrace): its syscall rows within 3 s."""
    src = bridge.NativeCapture(bridge.SRC_PTRACE, ring_pow2=14,
                               cfg=bridge.make_cfg(cmd=["true"]))
    seen = 0
    try:
        src.start()
        deadline = time.perf_counter() + 3.0
        while time.perf_counter() < deadline and not seen:
            b = src.pop()
            seen += int((b.cols["kind"][:b.count] == 18).sum())  # EV_SYSCALL
            time.sleep(0.05)
    except (OSError, RuntimeError) as e:
        log(f"[host] the ptrace source failed: {e}")
    finally:
        src.stop()
        src.close()
    return seen > 0


def scoped_cli(device: str, facts: dict, root: Path) -> dict:
    """Phase 5g(b): a 'container' (a copied shell named BLACK_BOX_COMM
    under ``unshare -m``, exec'ing /bin/true in a loop), then ``trace
    exec --source native --localmanager-containername BLACK_BOX_COMM
    --tpusketch-enable true --timeout 5 -o json`` as a subprocess: it
    must exit 0, its rows of the child's mount namespace name the
    container, none names another container, the last summary's events
    equal its rows and K2 runs once a step; a run with
    ``--localmanager-containername no-such-ctr`` must score none of the
    child's execs. Not run, and said so, where the host lacks root,
    ``unshare`` or the proc-exec source."""
    missing = [k for k in ("root", "unshare", "proc_exec") if facts[k] is not True]
    if missing:
        log(f"[containers] (5g b) not run: the card's host lacks {', '.join(missing)}")
        return {"ran": False, "missing": missing}
    root.mkdir(parents=True, exist_ok=True)
    shell = root / BLACK_BOX_COMM
    shutil.copy("/bin/bash", shell)
    shell.chmod(0o755)
    child = subprocess.Popen(["unshare", "-m", str(shell), "-c",
                              "for i in $(seq 1 1500); do /bin/true; sleep 0.02; done"])
    runs = {}
    try:
        time.sleep(1.0)  # the container must exist before the CLI's procfs scan
        mntns = os.stat(f"/proc/{child.pid}/ns/mnt").st_ino
        # the selected and the unselected run at once, on the same child
        dumps = {name: root / f"cli-{name}.json" for name in (BLACK_BOX_COMM, "no-such-ctr")}
        for dump in dumps.values():
            dump.unlink(missing_ok=True)
        done = run_at_once({
            name: [sys.executable, "-c", CLI_DRIVER, str(dump), "trace", "exec", "--device",
                   device, "--source", "native", "--localmanager-containername", name,
                   "--tpusketch-enable", "true", "--timeout", "5", "-o", "json"]
            for name, dump in dumps.items()}, timeout=240)
        for name, dump in dumps.items():
            proc, wall = done[name]
            require(proc is not None and proc.returncode == 0,
                    f"5g(b) CLI run ({name}): " + (f"exited {proc.returncode}: "
                                                   f"{proc.stderr[-2000:]}" if proc is not None
                                                   else "no exit in 240 s"))
            lines = proc.stdout.splitlines()
            rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
            epochs = [int(m[2].replace(",", "")) for m in map(EPOCH_RE.match, lines) if m]
            info = json.loads(dump.read_text())
            runs[name] = {"rows": rows, "epochs": epochs, "k2": info["k2_launches"],
                          "steps": _metric(info["metrics"], "ig_tpusketch_steps_total"),
                          "wall_s": wall}
    finally:
        child.kill()
        child.wait()
    pos, neg = runs[BLACK_BOX_COMM], runs["no-such-ctr"]
    mine = [r for r in pos["rows"] if r["mountnsid"] == mntns]
    foreign = [r for r in pos["rows"] if r.get("container") not in ("", BLACK_BOX_COMM)]
    require(mine and all(r["container"] == BLACK_BOX_COMM for r in mine) and not foreign,
            f"5g(b): {len(mine)} rows of the child's mount namespace, "
            f"{sum(r['container'] == BLACK_BOX_COMM for r in mine)} naming it, "
            f"{len(foreign)} naming another container")
    require(pos["epochs"] and pos["epochs"][-1] == len(pos["rows"]) and pos["steps"] > 0
            and (device != "cuda" or pos["k2"] == pos["steps"]),
            f"5g(b): last summary events {pos['epochs'][-1:]} against {len(pos['rows'])} rows, "
            f"K2 {pos['k2']} over {pos['steps']} steps")
    require(not [r for r in neg["rows"] if r["mountnsid"] == mntns]
            and all(e == 0 for e in neg["epochs"]),
            f"5g(b): the no-such-ctr run scored the child's execs: {neg['epochs'][-1:]}")
    log(f"[containers] (5g b) trace exec --source native --localmanager-containername "
        f"{BLACK_BOX_COMM} on the {device}: exit 0, {len(pos['rows'])} rows, {len(mine)} of "
        f"the child's mount namespace, all naming it; last summary {pos['epochs'][-1]} events "
        f"(= its rows); K2 {pos['k2']} over {pos['steps']:.0f} steps; {pos['wall_s']:.1f} s of "
        f"process; the no-such-ctr run: {len(neg['rows'])} rows, none of the child's, "
        f"summaries {neg['epochs'][-1:]} ({neg['wall_s']:.1f} s)")
    return {"ran": True, "rows": len(pos["rows"]), "mine": len(mine),
            "events": pos["epochs"][-1], "k2_launches": pos["k2"], "wall_s": pos["wall_s"],
            "negative_rows": len(neg["rows"]), "negative_wall_s": neg["wall_s"]}


# phase 5h: the trace gadget family. open, tcp and dns (the gadgets of the
# three synthetic kinds: SRC_SYNTH_EXEC, SRC_SYNTH_TCP, SRC_SYNTH_DNS) with
# 5d(a)'s sketch plane at full width, card then CPU; the other nine decoded
# only; then every real window the card's host offers
TRACE_SKETCHED = ("open", "tcp", "dns")
TRACE_DECODED = ("bind", "capabilities", "fsslower", "mount", "network", "oomkill", "signal",
                 "sni", "tcpconnect")
TRACE_BATCHES = 8  # 5h(a)'s runs, card and CPU: 16 until phase 5l came
TRACE_DECODE_BATCH = 8192
# each gadget's real event kinds (native/events.h): a synthetic row carries
# none of them, so its decoder took the synthetic branch
REAL_KINDS = {"open": {3}, "mount": {10}, "signal": {9}, "oomkill": {11}, "capabilities": {12},
              "bind": {8}, "fsslower": {13}, "tcp": {4, 5, 6}, "tcpconnect": {4}, "dns": {7},
              "sni": {16}, "network": {17}}
TRACE_SECONDS = 3.0  # each real-window run's timeout
TCP_DELAY = 1.5  # trace tcp's trigger waits this much longer (its set-up against the scanner)
TCP_BLACK_BOX_S = 90.0  # the black box's workload connects until its row streams, at most this
BIND_PORTS = (48712, 48713)  # tests/test_real_capture.py's TCP and UDP listeners
DNS_QNAME = "chip-smoke.example.com"


def trace_family(device: str, batch: int, exec_ev_per_s: float) -> dict:
    """Phase 5h(a): open, tcp and dns through `LocalRuntime` as 5d(a)
    runs trace/exec (pysynthetic seed 7, vocab 2000, every plane, ae) for
    TRACE_BATCHES batches of `batch` on `device`, K2 once a batch, then
    on the CPU, the summaries held to each other; then the other nine
    trace gadgets for 2 batches of TRACE_DECODE_BATCH with the sketch
    off: every row decoded, none of a real event kind, trace/signal's
    all "synth"."""
    out: dict = {"sketched": {}, "decoded": {}}
    for g in TRACE_SKETCHED:
        reset_launches()
        card = gadget_run(device, TRACE_BATCHES, batch, gadget=g)
        launched = read_launches()
        want = TRACE_BATCHES if device == "cuda" else 0
        require(launched == {"K1": 0, "K2": want, "K3": 0},
                f"trace {g}: launched {launched}, expected K2 {want} (once a batch)")
        cpu = gadget_run("cpu", TRACE_BATCHES, batch, gadget=g)
        csum, psum = card["summary"], cpu["summary"]
        require(csum.events == TRACE_BATCHES * batch and csum.inv is not None
                and csum.quantiles is not None and len(csum.heavy_hitters) > 0
                and csum.anomaly and all(np.isfinite(list(csum.anomaly.values()))),
                f"trace {g}: the final summary is malformed")
        gap = compare_summaries(csum, psum, f"trace {g}, card vs CPU", anomaly_rel=5e-2)
        real = card["kinds"] & REAL_KINDS[g]
        require(not real, f"trace {g}: synthetic batches carried real event kinds {real}")
        out["sketched"][g] = {"ev_per_s": card["ev_per_s"], "seconds": card["seconds"],
                              "cpu_ev_per_s": cpu["ev_per_s"], "cpu_seconds": cpu["seconds"],
                              "k2_launches": launched["K2"], "ae_rel_gap": gap,
                              "events": csum.events, "distinct": csum.distinct,
                              "entropy_bits": csum.entropy_bits, "harvest_ms": card["harvest_ms"]}
        log(f"[trace] (5h a) trace {g}, pysynthetic seed 7, {TRACE_BATCHES} x {batch}, every "
            f"plane: {device} {card['ev_per_s']:.0f} events/s ({card['ev_per_s'] / exec_ev_per_s:.2f}"
            f" x 5d(a)'s trace exec {exec_ev_per_s:.0f} in this run; {card['seconds']:.2f} s), "
            f"CPU {cpu['ev_per_s']:.0f} ({cpu['seconds']:.2f} s); K2 {launched['K2']}; final "
            f"summary equal to the CPU's (distinct ~{csum.distinct:.0f}, entropy "
            f"{csum.entropy_bits:.4f} b, ae within {gap:.3g} of a score)")
    for g in TRACE_DECODED:
        rows: list = []
        r = gadget_run(device, 2, TRACE_DECODE_BATCH, gadget=g, sketch=False, rows=rows)
        real = r["kinds"] & REAL_KINDS[g]
        require(len(rows) == sum(r["counts"]) == 2 * TRACE_DECODE_BATCH and not real,
                f"trace {g}: {len(rows)} rows of {sum(r['counts'])} events, real kinds {real}")
        if g == "signal":
            require(all(e.origin == "synth" for e in rows), "trace signal: a synthetic row "
                    "decoded as a capture")
        out["decoded"][g] = {"rows": len(rows), "kinds": sorted(r["kinds"]),
                             "seconds": r["seconds"]}
    log(f"[trace] (5h a) decoded, sketch off, 2 x {TRACE_DECODE_BATCH}: " + "; ".join(
        f"{g} {d['rows']} rows (kinds {d['kinds']}, {d['seconds']:.2f} s)"
        for g, d in out["decoded"].items()) + "; every row from the synthetic branch")
    return out


def real_run(device: str, gadget: str, flags: dict, trigger=None,
             timeout: float = TRACE_SECONDS, category: str = "trace",
             output: str = "columns", delay: float = 0.6) -> dict:
    """<category>/<gadget> (a trace gadget by default) with ``--source
    native --tpusketch-enable true`` and `timeout` through `LocalRuntime`,
    `trigger` run `delay` s after the start; the last summary's events must
    equal the events the gadget handed on (and a trace gadget's rows
    those events), and K2 must have run once a non-empty batch. A trace
    or audit gadget's rows come back decoded; a result gadget's result
    (rendered as `output`) comes back as it printed it."""
    from inspektor_gadget_tpu_torch import all_gadgets  # noqa: F401 — registers everything
    from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
    from inspektor_gadget_tpu_torch.operators import get as get_op
    from inspektor_gadget_tpu_torch.params import Collection
    from inspektor_gadget_tpu_torch.runtime import LocalRuntime
    desc = get(category, gadget)
    gp = desc.params().to_params()
    for k, v in {"source": "native", **flags}.items():
        gp.set(k, str(v))
    col = Collection({"operator.tpusketch.": get_op("tpusketch").instance_params().to_params()})
    col["operator.tpusketch."].set("enable", "true")
    summaries: list = []
    rows: list = []
    sizes: list[int] = []
    ctx = GadgetContext(desc, gadget_params=gp, operator_params=col, timeout=timeout,
                        extra={"on_sketch_summary": summaries.append, "output": output},
                        device=device)
    box: dict = {}
    decoded = category in ("trace", "audit")

    def run() -> None:
        box["res"] = LocalRuntime().run_gadget(
            ctx, on_event=rows.append if decoded else None,
            on_batch=lambda b: sizes.append(b.count))["local"]

    reset_launches()
    t0 = time.perf_counter()
    th = threading.Thread(target=run)
    th.start()
    try:
        time.sleep(delay)
        if trigger is not None:
            trigger()
    finally:
        th.join(timeout + 60)
        if th.is_alive():
            ctx.cancel()
            th.join(30)
    secs = time.perf_counter() - t0
    launched = read_launches()
    res = box.get("res")
    what = f"{category} {gadget} --source native"
    require(res is not None and res.error is None,
            f"{what}: {res.error if res else 'did not end'}")
    nonempty = sum(1 for n in sizes if n)
    last = summaries[-1].events if summaries else None
    require(last == sum(sizes) and (category != "trace" or last == len(rows)),
            f"{what}: last summary {last} events, {len(rows)} rows, {sum(sizes)} events in "
            f"batches")
    require(launched["K2"] == (nonempty if device == "cuda" else 0),
            f"{what}: K2 {launched['K2']} over {nonempty} non-empty batches")
    return {"rows": rows, "events": last, "k2_launches": launched["K2"], "batches": nonempty,
            "seconds": secs, "result": res.result}


def _repeat(cmd: list[str], times: int = 6, pause: float = 0.3):
    def trigger() -> None:
        for _ in range(times):
            subprocess.run(cmd, check=False, timeout=30)
            time.sleep(pause)
    return trigger


def real_windows(device: str, facts: dict) -> dict:
    """Phase 5h(b): every trace gadget whose kernel window the card's host
    offers, on real activity (tests/test_real_capture.py's triggers), each
    held by `real_run`; a gadget whose window is absent is logged as
    skipped with the probe that said so. mount and oomkill are not run
    here: they would mount a filesystem or force an OOM on a shared host."""
    from tools.dnstester import build_query
    out: dict = {}

    def skip(g: str, probe: str) -> None:
        log(f"[trace] {g}: skipped: {probe} false")
        out[g] = {"ran": False, "probe": probe}

    def held(g: str, r: dict, what: str) -> None:
        out[g] = {"ran": True, **{k: v for k, v in r.items() if k != "rows"}}
        log(f"[trace] (5h b) {g} --source native on the {device}: {len(r['rows'])} rows, last "
            f"summary {r['events']} events (= its rows), K2 {r['k2_launches']} over "
            f"{r['batches']} non-empty batches, {r['seconds']:.1f} s; {what}")

    tmp = Path(tempfile.mkdtemp(prefix="igtrace-"))
    try:
        # open: a child writes then reads a named file under a temporary directory
        if facts["fanotify_supported"]:
            probe = tmp / "ig_trace_open"
            r = real_run(device, "open", {"paths": str(tmp)}, _repeat(
                ["sh", "-c", f"echo payload > {probe} && cat {probe} >/dev/null"]))
            hits = [e for e in r["rows"] if e.path == str(probe)]
            require(hits and all(e.pid > 0 and e.comm for e in hits),
                    f"trace open: {len(hits)} rows name {probe}")
            held("open", r, f"{len(hits)} rows name the child's file, ops "
                 f"{sorted({e.op for e in hits})}")
        else:
            skip("open", "fanotify_supported")
        # bind: a TCP and a UDP listener on fixed ports
        socks: list = []

        def listen() -> None:
            tcp = socket.socket()
            tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            tcp.bind(("127.0.0.1", BIND_PORTS[0]))
            tcp.listen(1)
            udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            udp.bind(("0.0.0.0", BIND_PORTS[1]))
            socks.extend((tcp, udp))
        try:
            r = real_run(device, "bind", {}, listen)
        finally:
            for sk in socks:
                sk.close()
        ports = {e.port: e.protocol for e in r["rows"] if e.port in BIND_PORTS}
        require(ports == {BIND_PORTS[0]: "tcp", BIND_PORTS[1]: "udp"},
                f"trace bind: the listeners' rows {ports}")
        held("bind", r, f"both listeners ({ports})")
        # tcp: connects to a listener opened after the capture started,
        # each held past the /proc/net/tcp scanner's 50 ms polls (the
        # window where the inet_sock_set_state tracepoint is absent)
        window = "inet_sock_set_state" if facts["sockstate_supported"] else "/proc/net/tcp"
        box: dict = {}

        def connect() -> None:
            with socket.socket() as ls:
                ls.bind(("127.0.0.1", 0))
                ls.listen(8)
                box["port"] = ls.getsockname()[1]
                for _ in range(5):
                    c = socket.create_connection(("127.0.0.1", box["port"]), timeout=2.0)
                    conn, _ = ls.accept()
                    time.sleep(0.2)
                    c.close()
                    conn.close()
                    time.sleep(0.2)
        # the /proc/net/tcp scanner calls a socket an accept when it first
        # sees it listening: the listener must open after the scanner's
        # first pass, which a slow host's run set-up can push past 0.6 s
        r = real_run(device, "tcp", {}, connect, timeout=TRACE_SECONDS + TCP_DELAY,
                     delay=0.6 + TCP_DELAY)
        ops = {e.operation for e in r["rows"] if box["port"] in (e.dport, e.sport)}
        require({"connect", "accept", "close"} <= ops,
                f"trace tcp ({window}): the listener's port {box['port']} in rows of "
                f"{sorted(ops)}")
        held("tcp", r, f"the {window} window: connect, accept and close rows carry port "
             f"{box['port']}")
        # the ptrace window: capabilities, signal, fsslower on a --command
        target = tmp / "ig_trace_cap"
        target.write_text("x")
        ptrace_runs = (
            ("capabilities", {"command": f"chown 0:0 {target}"},
             lambda e: e.cap == "CHOWN", "CHOWN rows"),
            ("signal", {"command": "sh -c 'kill -USR1 $$'"},
             lambda e: e.signal == "SIGUSR1", "SIGUSR1 rows"),
            ("fsslower", {"command": f"dd if=/dev/zero of={tmp / 'ig_trace_fs'} bs=4096 "
                                     "count=16 conv=fsync status=none", "min-latency": "0"},
             lambda e: e.file == str(tmp / "ig_trace_fs"), "rows of the written file"))
        for g, flags, match, what in ptrace_runs:
            if not facts["ptrace"]:
                skip(g, "ptrace")
                continue
            r = real_run(device, g, flags, timeout=5.0)
            hits = [e for e in r["rows"] if match(e)]
            require(hits, f"trace {g}: no {what} among {len(r['rows'])}")
            held(g, r, f"{len(hits)} {what}" + (
                f" (ops {sorted({e.op for e in hits})})" if g == "fsslower" else ""))
        # dns: UDP queries to a listener on 127.0.0.1:53
        if facts["cap_net_raw"]:
            query = build_query(DNS_QNAME)
            srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                srv.bind(("127.0.0.1", 53))
            except OSError as e:  # a resolver already listens there: the query still flows
                log(f"[trace] dns: 127.0.0.1:53 taken ({e}); sending to it all the same")

            def ask() -> None:
                with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as c:
                    for _ in range(5):
                        c.sendto(query, ("127.0.0.1", 53))
                        time.sleep(0.1)
            try:
                r = real_run(device, "dns", {}, ask)
            finally:
                srv.close()
            hits = [e for e in r["rows"] if e.name == DNS_QNAME]
            require(hits and all(e.qr == "Q" and e.qtype == "A" for e in hits),
                    f"trace dns: {len(hits)} rows of the query for {DNS_QNAME}")
            held("dns", r, f"{len(hits)} query rows for {DNS_QNAME}")
        else:
            skip("dns", "cap_net_raw")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["black_box"] = trace_tcp_black_box()
    return out


def trace_tcp_black_box() -> dict:
    """``ig-tpu-torch trace tcp --source native -o json`` through the
    port's step framework, as tests/test_torch_steps.py runs it: a
    start-and-stop `Command` beside a workload that connects to a local
    listener, each connection held 0.2 s, until the command has streamed
    a connect row for the listener's port and made two more (the CLI's
    start takes 7-24 s on the card's hosts), or for TCP_BLACK_BOX_S; the
    connect row held by `expect_entries_to_match`."""
    from inspektor_gadget_tpu_torch.testing import (Command, FuncStep, build_common_data,
                                                    expect_entries_to_match, run_test_steps)
    from inspektor_gadget_tpu_torch.testing.steps import ig_cli
    box: dict = {"connects": 0, "seen_s": None}

    def streamed_connect() -> bool:
        rows = [json.loads(ln) for ln in cmd.output().splitlines() if ln.startswith("{")]
        return any(r.get("operation") == "connect" and r.get("dport") == box["port"]
                   for r in rows)

    def workload() -> None:
        ls = socket.socket()
        ls.bind(("127.0.0.1", 0))
        ls.listen(8)
        box["port"] = ls.getsockname()[1]
        t_start = time.monotonic()
        more = None
        while time.monotonic() < t_start + TCP_BLACK_BOX_S and more != 0:
            c = socket.create_connection(("127.0.0.1", box["port"]), timeout=2.0)
            conn, _ = ls.accept()
            time.sleep(0.2)  # past a /proc/net/tcp poll, where that is the window
            c.close()
            conn.close()
            box["connects"] += 1
            time.sleep(0.2)
            if more is None and streamed_connect():
                box["seen_s"], more = round(time.monotonic() - t_start, 1), 2
            elif more:
                more -= 1
        ls.close()

    def normalize(e: dict) -> None:
        for k in ("timestamp", "pid", "mountnsid", "netnsid", "comm", "saddr", "daddr",
                  "sport"):
            e.pop(k, None)
        if e.get("dport") != box.get("port"):
            e.clear()
            e["skip"] = True

    def check(output: str) -> None:
        box["rows"] = sum(1 for ln in output.splitlines() if ln.startswith("{"))
        expect_entries_to_match(output, normalize,
                                {"operation": "connect", "ipversion": 4, "dport": box["port"],
                                 "type": "normal", **build_common_data()})

    t0 = time.perf_counter()
    cmd = Command(name="trace-tcp", cmd=ig_cli("trace", "tcp", "--source", "native", "-o",
                                               "json"),
                  start_and_stop=True, ready_timeout=60.0, stop_grace=20.0,
                  expected_output_fn=check)
    run_test_steps([cmd, FuncStep(name="workload", fn=workload)], step_wait=1.0)
    secs = time.perf_counter() - t0
    log(f"[trace] (5h b) black box: ig-tpu-torch trace tcp --source native -o json through "
        f"the step framework: {box['rows']} rows, the connect to port {box['port']} matched "
        f"({box['connects']} connects; streamed {box['seen_s']} s into the workload), "
        f"exit {cmd.returncode}, {secs:.1f} s")
    return {"ran": True, "rows": box["rows"], "connects": box["connects"],
            "streamed_s": box["seen_s"], "seconds": secs}



# phase 5i: the remaining gadgets (ROADMAP 17b). (a) the four gadgets of a
# capture source with 5d(a)'s sketch plane at full width, card then CPU;
# (b) every real window of the 17b gadgets the card's host offers
SYSCALL_GADGETS = (("audit", "seccomp", 16), ("advise", "seccomp-profile", 4),
                   ("advise", "network-policy", 2),  # 4 until phase 5k came
                   ("traceloop", "traceloop", 4))
TOP_SECONDS = 2.2  # each top gadget's run at --interval 1s: two ticks
DD_FOLD_N = 10_000  # the direct fold's seeded latencies


def syscall_gadgets(device: str, batch: int, exec_ev_per_s: float) -> dict:
    """Phase 5i(a): audit seccomp, advise seccomp-profile, advise
    network-policy and traceloop through `LocalRuntime` as 5d(a) runs
    trace/exec (pysynthetic seed 7, vocab 2000, every plane, ae) on
    `device`, K2 once a batch, then on the CPU, K2 never: the final
    summaries held to each other by `compare_summaries` and the result
    bytes (the OCI profiles' JSON, the policies' YAML, the traceloop
    table, which has no timestamp column) equal."""
    out: dict = {}
    for category, name, batches in SYSCALL_GADGETS:
        what = f"{category} {name}"
        reset_launches()
        card = gadget_run(device, batches, batch, category=category, gadget=name)
        launched = read_launches()
        want = batches if device == "cuda" else 0
        require(launched == {"K1": 0, "K2": want, "K3": 0},
                f"{what}: launched {launched}, expected K2 {want} (once a batch)")
        reset_launches()
        cpu = gadget_run("cpu", batches, batch, category=category, gadget=name)
        require(read_launches()["K2"] == 0, f"{what}: the CPU run launched K2")
        csum, psum = card["summary"], cpu["summary"]
        require(csum.events == batches * batch and csum.inv is not None
                and csum.quantiles is not None and len(csum.heavy_hitters) > 0
                and csum.anomaly and all(np.isfinite(list(csum.anomaly.values()))),
                f"{what}: the final summary is malformed")
        gap = compare_summaries(csum, psum, f"{what}, card vs CPU", anomaly_rel=5e-2)
        res, cres = card["result"], cpu["result"]
        if category == "audit":
            require(res is None and cres is None, f"{what}: a trace gadget returned a result")
        else:
            require(isinstance(res, bytes) and len(res) > 200 and res == cres,
                    f"{what}: the card's result ({len(res or b'')} bytes) differs from the "
                    f"CPU's ({len(cres or b'')} bytes)")
        out[f"{category}/{name}"] = {
            "batches": batches, "ev_per_s": card["ev_per_s"], "seconds": card["seconds"],
            "cpu_ev_per_s": cpu["ev_per_s"], "cpu_seconds": cpu["seconds"],
            "k2_launches": launched["K2"], "ae_rel_gap": gap, "events": csum.events,
            "distinct": csum.distinct, "entropy_bits": csum.entropy_bits,
            "result_bytes": len(res or b"")}
        log(f"[17b] (5i a) {what}, pysynthetic seed 7, {batches} x {batch}, every plane: "
            f"{device} {card['ev_per_s']:.0f} events/s ({card['ev_per_s'] / exec_ev_per_s:.2f} x "
            f"5d(a)'s trace exec {exec_ev_per_s:.0f} in this run; {card['seconds']:.2f} s), "
            f"CPU {cpu['ev_per_s']:.0f} ({cpu['seconds']:.2f} s); K2 {launched['K2']}; final "
            f"summary equal to the CPU's (distinct ~{csum.distinct:.0f}, entropy "
            f"{csum.entropy_bits:.4f} b, ae within {gap:.3g} of a score)"
            + (f"; result {len(res)} bytes, equal to the CPU's" if res else ""))
    return out


class DiskWriter:
    """A child process that writes 64 KiB to a file and fsyncs it every
    50 ms, so the block and file windows have IO to see (a child: the
    fanotify source does not report its own process's accesses)."""

    CODE = ("import os, sys, time\nchunk = os.urandom(1 << 16)\n"
            "with open(sys.argv[1], 'wb') as f:\n"
            "    for i in range(1, 1 << 30):\n"
            "        f.write(chunk); f.flush(); os.fsync(f.fileno())\n"
            "        if i % 64 == 0: f.seek(0)\n"
            "        time.sleep(0.05)\n")

    def __init__(self, path: Path):
        self.path = path
        self.proc: subprocess.Popen | None = None

    def __enter__(self):
        self.proc = subprocess.Popen([sys.executable, "-S", "-c", self.CODE, str(self.path)])
        return self

    def __exit__(self, *exc):
        self.proc.kill()
        self.proc.wait(30)


def block_device_of(path: Path) -> str | None:
    """The /proc/diskstats name of the block device holding `path`, or
    None where its device is not listed there (overlay, tmpfs)."""
    st = os.stat(path)
    major, minor = os.major(st.st_dev), os.minor(st.st_dev)
    with open("/proc/diskstats") as f:
        for line in f:
            parts = line.split()
            if len(parts) > 2 and (int(parts[0]), int(parts[1])) == (major, minor):
                return parts[2]
    return None


def top_run(name: str, params: dict, seconds: float = TOP_SECONDS) -> list:
    """top/<name> through `LocalRuntime` at --interval 1s for `seconds`:
    the rows of every tick."""
    from inspektor_gadget_tpu_torch import all_gadgets  # noqa: F401 — registers everything
    from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
    from inspektor_gadget_tpu_torch.runtime import LocalRuntime
    desc = get("top", name)
    gp = desc.params().to_params()
    for k, v in {"interval": "1s", "max-rows": "10000", **params}.items():
        gp.set(k, v)
    ticks: list = []
    ctx = GadgetContext(desc, gadget_params=gp, timeout=seconds, device="cpu")
    res = LocalRuntime().run_gadget(ctx, on_event_array=ticks.append)["local"]
    require(res.error is None and ticks, f"top {name}: {res.error or 'no tick'}")
    return [r for t in ticks for r in t]


def result_run(category: str, name: str, params: dict, seconds: float, device: str) -> bytes:
    """A result gadget without a capture source (profile cpu, profile
    block-io) through `LocalRuntime` for `seconds`: its result bytes."""
    from inspektor_gadget_tpu_torch import all_gadgets  # noqa: F401 — registers everything
    from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
    from inspektor_gadget_tpu_torch.runtime import LocalRuntime
    desc = get(category, name)
    gp = desc.params().to_params()
    for k, v in params.items():
        gp.set(k, v)
    ctx = GadgetContext(desc, gadget_params=gp, timeout=seconds, device=device)
    res = LocalRuntime().run_gadget(ctx)["local"]
    require(res.error is None and isinstance(res.result, bytes),
            f"{category} {name}: {res.error or 'no result'}")
    return res.result


def dd_fold(device: str, seed: int) -> dict:
    """DD_FOLD_N seeded latencies through profile block-io's own `_fold`
    (in chunks of its flush size) and `_quantile_summary` on `device`."""
    from inspektor_gadget_tpu_torch import all_gadgets  # noqa: F401 — registers everything
    from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
    desc = get("profile", "block-io")
    gp = desc.params().to_params()
    gp.set("quantiles", "true")
    g = desc.new_instance(GadgetContext(desc, gadget_params=gp, device=device))
    rng = np.random.default_rng(seed)
    us = np.maximum(rng.lognormal(5.0, 1.5, DD_FOLD_N).astype(np.int64), 1)
    obs = [(int(u) / 1e6, int(w)) for u, w in zip(us, rng.integers(1, 40, DD_FOLD_N))]
    t0 = time.perf_counter()
    sk = None
    for i in range(0, len(obs), g._FLUSH):
        sk = g._fold(sk, obs[i:i + g._FLUSH])
    line = g._quantile_summary(sk)
    secs = time.perf_counter() - t0
    require(sk.counts.device.type == torch.device(device).type,
            f"profile block-io's fold ran on {sk.counts.device}, asked for {device}")
    return {"counts": sk.counts.cpu(), "zeros": int(sk.zeros), "total": int(sk.total),
            "line": line, "seconds": secs, "weight": sum(w for _, w in obs)}


def remaining_windows(device: str, facts: dict, root: Path) -> dict:
    """Phase 5i(b): the 17b gadgets on the real windows the card's host
    offers, each checked, each absent window logged with its probe: the
    ptrace trio (traceloop, advise seccomp-profile, audit seccomp on a
    ``--command``, through `real_run`); top block-io, file, tcp, metrics
    and self at --interval 1s; profile cpu (folded and columns) on a
    spinning child; profile block-io --quantiles true on `device` while
    a thread fsyncs a file under `root`; and the DDSketch fold direct on
    `device` and on the CPU."""
    from inspektor_gadget_tpu_torch.gadgets.top.file import _fanotify_window_available
    out: dict = {}

    def skip(g: str, probe: str) -> None:
        log(f"[17b] {g}: skipped: {probe} false")
        out[g] = {"ran": False, "probe": probe}

    def done(g: str, info: dict, what: str) -> None:
        out[g] = {"ran": True, **info}
        log(f"[17b] (5i b) {g}: {what}")

    root.mkdir(parents=True, exist_ok=True)
    # the ptrace window; the chown probe sits where uid 1 can reach it, so
    # the kernel's answer is the EPERM of the chown itself
    probe_dir = Path(tempfile.mkdtemp(prefix="ig17b-"))
    probe_dir.chmod(0o755)
    probe = probe_dir / "audit_probe"
    probe.write_text("x")
    os.chown(probe, 0, 0)
    chown = (f"{sys.executable} -S -c \"import os; os.setuid(1); "
             f"os.chown('{probe}', 1, 1)\"")
    for category, name, flags, output in (
            ("traceloop", "traceloop", {"command": "cat /etc/hostname"}, "json"),
            ("advise", "seccomp-profile", {"command": "cat /etc/hostname"}, "columns"),
            ("audit", "seccomp", {"command": chown}, "columns")):
        g = f"{category} {name}"
        if not facts["ptrace"]:
            skip(g, "ptrace")
            continue
        r = real_run(device, name, flags, timeout=8.0, category=category, output=output)
        if name == "traceloop":
            recs = json.loads(r["result"])
            names = {x["syscall"] for x in recs}
            opens = [x for x in recs if x["syscall"] == "openat" and "/etc/hostname" in x["args"]]
            require({"execve", "openat"} <= names and opens and opens[0]["ret"] == 3,
                    f"{g}: syscalls {sorted(names)[:20]}, {len(opens)} openat of /etc/hostname "
                    f"returning {[x['ret'] for x in opens]}")
            what = f"{len(recs)} records, openat(/etc/hostname) = {opens[0]['ret']}"
        elif name == "seccomp-profile":
            (prof,) = json.loads(r["result"]).values()
            names = set(prof["syscalls"][0]["names"])
            require({"execve", "openat", "read", "close"} <= names and "reboot" not in names,
                    f"{g}: the profile's names {sorted(names)}")
            what = f"a profile of {len(names)} syscalls, execve, openat, read and close in, " \
                   "reboot out"
        else:
            denied = [e for e in r["rows"] if e.code == "ERRNO"
                      and e.syscall in ("chown", "fchownat")]
            require(denied, f"{g}: no ERRNO row for chown among "
                    f"{[(e.syscall, e.code) for e in r['rows']]}")
            what = f"{len(r['rows'])} rows, ERRNO {denied[0].syscall}"
        done(g, {k: v for k, v in r.items() if k not in ("rows", "result")},
             f"--source native --tpusketch-enable true on the {device}: {what}; last summary "
             f"{r['events']} events (= the events handed on), K2 {r['k2_launches']} over "
             f"{r['batches']} non-empty batches, {r['seconds']:.1f} s")
    shutil.rmtree(probe_dir, ignore_errors=True)
    writer_file = root / "writer.bin"
    with DiskWriter(writer_file) as writer:
        time.sleep(0.3)
        # top block-io: the device under root/, where diskstats lists it
        dev = block_device_of(root) if facts["diskstats"] else None
        rows = top_run("block-io", {})
        mine = [r for r in rows if r.device == dev]
        if dev is not None:
            require(mine and sum(r.writes for r in mine) > 0,
                    f"top block-io: no writes on {dev} among {[r.device for r in rows]}")
            what = (f"{dev} (under {root.name}/) {sum(r.writes for r in mine)} writes, "
                    f"{sum(r.wbytes for r in mine)} bytes")
        elif facts["diskstats"]:
            what = (f"{root.name}/ is on no device /proc/diskstats lists (overlay or tmpfs): "
                    f"devices seen {sorted({r.device for r in rows})}")
        else:
            require(not rows, f"top block-io: {len(rows)} rows without /proc/diskstats")
            what = "the writes not checked: diskstats false (no /proc/diskstats)"
        done("top block-io", {"rows": len(rows), "device": dev,
                              "writes": sum(r.writes for r in mine)},
             f"{len(rows)} rows; {what}")
        # top file: the writer's file on fanotify, this process on procio
        fan = _fanotify_window_available()
        params = {"paths": str(root)} if fan else {}
        rows = top_run("file", params)
        if fan:
            mine = [r for r in rows if r.file == str(writer_file) and r.writes > 0]
        else:
            mine = [r for r in rows if r.pid == writer.proc.pid and r.writes > 0]
        require(mine, f"top file ({'fanotify' if fan else 'procio'}): no row of the writer "
                f"among {len(rows)}")
        done("top file", {"window": "fanotify" if fan else "procio", "rows": len(rows)},
             f"the {'fanotify' if fan else 'procio'} window: {len(rows)} rows, the writer's "
             f"{'file' if fan else 'process'} with {sum(r.writes for r in mine)} writes, "
             f"{sum(r.wbytes for r in mine)} bytes")
        # profile block-io --quantiles true on the card while the writer fsyncs
        t0 = time.perf_counter()
        text = result_run("profile", "block-io", {"quantiles": "true"}, 2.0, device).decode()
        counts = [int(ln.split(":")[1].split("|")[0]) for ln in text.splitlines()
                  if "->" in ln and ":" in ln]
        window = "blktrace" if "source: tracefs block events" in text else "diskstats"
        require("distribution" in text and (sum(counts) > 0) == ("p50=" in text),
                f"profile block-io: {sum(counts)} IOs in the histogram, quantile line "
                f"{'p50=' in text}:\n{text}")
        qline = [ln for ln in text.splitlines() if "p50=" in ln]
        done("profile block-io", {"window": window, "ios": sum(counts),
                                  "quantiles": qline[0] if qline else None,
                                  "seconds": time.perf_counter() - t0},
             f"--quantiles true on the {device}, the {window} window"
             + ("" if facts["diskstats"] or window != "diskstats" else
                " (diskstats false: no /proc/diskstats)")
             + f": {sum(counts)} IOs in the histogram; "
             + (qline[0].strip() if qline else "no IO seen, so no quantile line (the "
                                              "histogram is empty too)"))
    # top tcp: a local connection that sends a known byte count
    sent_total = 48 * 65536
    box: dict = {}
    stop = threading.Event()

    def serve(ls) -> None:
        conn, _ = ls.accept()
        while conn.recv(65536):
            pass
        conn.close()

    def client() -> None:
        time.sleep(1.0)  # the byte source's first dump comes first: every byte is a delta
        cs = socket.create_connection(("127.0.0.1", box["port"]))
        for _ in range(48):
            cs.sendall(b"x" * 65536)
            time.sleep(0.02)
        stop.wait(10.0)  # held open until the gadget is done: its last delta
        cs.close()

    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    box["port"] = ls.getsockname()[1]
    st = threading.Thread(target=serve, args=(ls,))
    ct = threading.Thread(target=client)
    st.start()
    ct.start()
    try:
        rows = top_run("tcp", {"source": "native"}, seconds=3.2)
    finally:
        stop.set()
        ct.join(15)
        st.join(15)
        ls.close()
    # the byte window names ports in decimal, the churn window as /proc/net/tcp
    # has them, in hex
    named = re.compile(rf":(?:{box['port']}|{box['port']:x})(?![0-9a-f])")
    mine = [r for r in rows if named.search(r.conn.lower())]
    if facts["tcpinfo_supported"]:
        require(sum(r.sent for r in mine) >= sent_total,
                f"top tcp (INET_DIAG_INFO): SENT {sum(r.sent for r in mine)} on port "
                f"{box['port']}, {sent_total} sent")
        what = (f"the INET_DIAG_INFO byte window: {len(mine)} rows of port {box['port']}, SENT "
                f"{sum(r.sent for r in mine)} (>= the {sent_total} bytes sent)")
    else:
        require(mine and all(r.sent == r.recv == 0 for r in rows),
                f"top tcp (churn): {len(mine)} of {len(rows)} rows name port {box['port']}, "
                f"bytes {[(r.sent, r.recv) for r in rows]}")
        what = (f"churn (tcpinfo_supported false): {len(rows)} rows, {len(mine)} naming port "
                f"{box['port']} ({mine[0].conn}), SENT and RECV 0 on every row")
    done("top tcp", {"rows": len(rows), "mine": len(mine), "bytes_window":
                     facts["tcpinfo_supported"], "sent": sum(r.sent for r in mine)}, what)
    # top metrics: 5i(a)'s sketch series are in the port's registry
    rows = top_run("metrics", {})
    sk = [r for r in rows if r.metric.startswith("ig_tpusketch_")
          and 'gadget="audit/seccomp"' in r.labels]
    require(sk, f"top metrics: no ig_tpusketch_* series of audit/seccomp among {len(rows)}")
    done("top metrics", {"rows": len(rows), "tpusketch_audit_rows": len(sk)},
         f"{len(rows)} rows, {len(sk)} ig_tpusketch_* series of audit/seccomp")
    # top self beside a native synthetic trace exec
    from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
    from inspektor_gadget_tpu_torch.runtime import LocalRuntime
    desc = get("trace", "exec")
    gp = desc.params().to_params()
    gp.set("source", "synthetic")
    gp.set("rate", "100000")
    tctx = GadgetContext(desc, gadget_params=gp, timeout=6.0, device=device)
    th = threading.Thread(target=lambda: LocalRuntime().run_gadget(tctx), daemon=True)
    th.start()
    try:
        time.sleep(0.8)
        rows = top_run("self", {})
    finally:
        tctx.cancel()
        th.join(10)
    ex = [r for r in rows if r.source == "synth/exec" and r.produced > 0]
    require(ex, f"top self: no synth/exec source producing among {[r.source for r in rows]}")
    done("top self", {"rows": len(rows), "produced": max(r.produced for r in ex)},
         f"{len(rows)} rows; trace exec's synth/exec source produced "
         f"{max(r.produced for r in ex)}, {max(r.rate for r in ex):.0f} events/s, "
         f"{max(r.cpu_pct for r in ex):.1f}% CPU")
    # profile cpu on a spinning child, folded and columns
    perf = facts["perf_supported"]
    comm = os.path.basename(sys.executable)[:15]
    spin = subprocess.Popen([sys.executable, "-S", "-c",
                             "import time\nt=time.time()\nwhile time.time()-t<8: pass"])
    try:
        time.sleep(0.2)
        folded = result_run("profile", "cpu", {"pid": str(spin.pid),
                                                "profile-output": "folded"}, 2.5, device)
        columns = result_run("profile", "cpu", {"pid": str(spin.pid)}, 2.5, device)
    finally:
        spin.kill()
        spin.wait()
    lines = [ln for ln in folded.decode().splitlines() if ln.strip()]
    total = sum(int(ln.rsplit(" ", 1)[1]) for ln in lines)
    require(any(ln.startswith((comm + ";", comm + ":")) for ln in lines)
            and comm.encode() in columns and (not perf or total >= 20),
            f"profile cpu ({'perf' if perf else 'procfs'}): {total} samples, {lines[:5]}")
    done("profile cpu", {"sampler": "perf" if perf else "procfs", "samples": total,
                         "stacks": len(lines)},
         f"the {'perf' if perf else 'procfs'} sampler: {total} samples of the spinning "
         f"{comm} in {len(lines)} folded stacks; its comm in the columns table")
    # the DDSketch fold, direct, on the device and on the CPU
    card, cpu = dd_fold(device, 11), dd_fold("cpu", 11)
    require(torch.equal(card["counts"], cpu["counts"]) and card["zeros"] == cpu["zeros"]
            and card["total"] == cpu["total"] == card["weight"] and card["line"] == cpu["line"],
            f"the DDSketch fold: {device} {card['total']} {card['line']!r}, CPU {cpu['total']} "
            f"{cpu['line']!r}")
    done("dd fold", {"total": card["total"], "line": card["line"].decode().strip(),
                     "seconds": card["seconds"], "cpu_seconds": cpu["seconds"]},
         f"{DD_FOLD_N} seeded latencies through profile block-io's _fold on the {device} "
         f"({card['seconds'] * 1e3:.1f} ms) and the CPU ({cpu['seconds'] * 1e3:.1f} ms): equal "
         f"counts, total {card['total']}; {card['line'].decode().strip()}")
    shutil.rmtree(root, ignore_errors=True)
    return out


# phase 5j: the agent (ROADMAP 18a). (a) the port's AgentServer in this
# process on a unix socket, driven through AgentClient: a shared RunGadget
# with a summary-tier subscriber, then a run with history and a
# recording; (b) `ig-tpu-torch agent` as a user starts it, a subprocess
AGENT_BATCHES = 8        # the owner stops the shared run once the source has popped this many
AGENT_CLI_BATCHES = 2    # (b)'s run, paced at one batch a second
AGENT_LIVENESS_S = 120.0  # (b)'s deadline for `agent liveness` to answer
AGENT_HARVEST = "300ms"  # (a)'s history run: a window a harvest, at least two
# runs the CLI module as `python -m` does (runpy, as __main__), with
# torch's import timed and printed first
AGENT_DRIVER = """\
import runpy, time
t0 = time.perf_counter()
import torch  # noqa: F401 -- the agent's first import
print(f"[driver] torch import {time.perf_counter() - t0:.3f} s", flush=True)
runpy.run_module("inspektor_gadget_tpu_torch.cli.main", run_name="__main__", alter_sys=True)
"""


def agent_params(batch: int, rate: str = "1e9", **sketch: str) -> dict:
    """5d(a)'s run as a RunGadget's flat params: trace/exec on pysynthetic
    (seed 7, vocab 2000, zipf 1.2, batches of `batch` at `rate` events/s)
    with GADGET_SKETCH and a harvest interval of 1h; `sketch` overrides
    tpusketch params."""
    flat = {"gadget.source": "pysynthetic", "gadget.seed": "7", "gadget.vocab": "2000",
            "gadget.zipf": "1.2", "gadget.batch-size": str(batch), "gadget.rate": rate,
            "operator.tpusketch.enable": "true"}
    for k, v in {**GADGET_SKETCH, "harvest-interval": "1h", **sketch}.items():
        flat[f"operator.tpusketch.{k.replace('_', '-')}"] = v
    return flat


def compare_wire_summaries(got: dict, want: dict, what: str, anomaly_rel: float) -> float:
    """`compare_summaries` on two decoded EV_SUMMARY frames (the wire's
    dict shape): `distinct` and `entropy` bit for bit, the accuracy block
    to 1e-4, each container's anomaly score within `anomaly_rel` of the
    score, the rest exactly, `pipeline` and the frame's own keys aside.
    Returns the largest relative anomaly gap."""
    g = {k: v for k, v in got.items() if k not in ("pipeline", "node", "seq", "type")}
    w = {k: v for k, v in want.items() if k not in ("pipeline", "node", "seq", "type")}
    for key in ("distinct", "entropy"):
        require(g[key] == w[key], f"{what} {key}: {g[key]!r} != {w[key]!r} (bit for bit)")
    _same(g.pop("accuracy", None), w.pop("accuracy", None), 1e-4, f"{what} accuracy")
    ga, wa = g.pop("anomaly") or {}, w.pop("anomaly") or {}
    require(sorted(ga) == sorted(wa), f"{what}: scored containers differ")
    gap = max((abs(ga[k] - wa[k]) / max(abs(wa[k]), 1e-12) for k in wa), default=0.0)
    require(gap <= anomaly_rel, f"{what}: anomaly scores differ by {gap:.3g} of a score")
    require(sorted(g) == sorted(w), f"{what}: keys {sorted(g)} != {sorted(w)}")
    _same({k: g[k] for k in sorted(g)}, {k: w[k] for k in sorted(w)}, 0.0, what)
    return gap


def _source_batches() -> float:
    from inspektor_gadget_tpu_torch.telemetry import snapshot
    return _metric(snapshot(), "ig_source_batches_total")


def agent_route(device: str, batch: int, root: Path, local_ev_per_s: float) -> dict:
    """Phase 5j (a): `serve` on a unix socket under a temp directory
    (node n0, `device`), then through `AgentClient`: the catalog equals
    `build_catalog()`; a shared RunGadget (about AGENT_BATCHES batches of
    `agent_params`, outputs summary) with a second, compatible request
    riding it as a summary-tier subscriber, ended by the owner's
    whole-run stop: both final summaries one frame but for the seq, K2
    once a batch, the summary equal to `gadget_run` of the same stream on
    the CPU. Then the same run with history (a window a harvest every
    AGENT_HARVEST) under a StartRecording: ListWindows lists a window a
    harvest, QueryWindows' answer equals `answer_query` over the store,
    the fetched recording replays on `device` to every recorded digest,
    and DumpState lists the finished shared runs and the alert table.
    The server is stopped and waited for before it returns. Runs on the
    CPU too, at small sizes."""
    from inspektor_gadget_tpu_torch.agent import client as client_mod
    from inspektor_gadget_tpu_torch.agent import wire
    from inspektor_gadget_tpu_torch.agent.client import AgentClient
    from inspektor_gadget_tpu_torch.agent.service import serve
    from inspektor_gadget_tpu_torch.capture import RECORDINGS, iter_journals, replay_journal
    from inspektor_gadget_tpu_torch.history import HISTORY, answer_query, decode_frames
    from inspektor_gadget_tpu_torch.runtime.runtime import build_catalog
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    sock_dir = Path(tempfile.mkdtemp(prefix="igtpu-smoke-"))
    target = f"unix://{sock_dir}/a.sock"
    t_phase = time.perf_counter()
    server, agent = serve(target, node_name="n0", device=device)
    clients: list = []

    def client(name: str):
        c = AgentClient(target, name, rpc_deadline=120.0)
        clients.append(c)
        return c

    frames: dict[str, list[bytes]] = {}
    decode = wire.decode_msg

    def spy(data: bytes):
        h, p = decode(data)
        if h.get("type") == wire.EV_SUMMARY:
            frames.setdefault(threading.current_thread().name, []).append(data)
        return h, p

    client_mod.wire.decode_msg = spy
    out: dict = {}
    try:
        probe = client("probe")
        cat = probe.get_catalog(use_cache_on_error=False)
        require(cat.pop("node") == "n0" and cat == build_catalog(),
                "agent: GetCatalog differs from build_catalog()")

        def drive(run_id: str, params: dict, *, subscriber: bool, stop_when) -> dict:
            """The owner's shared run (and a summary-tier subscriber's
            compatible request), stopped for every subscriber once
            `stop_when()` holds; returns each one's out dict, summaries
            and seconds."""
            stop = threading.Event()
            res: dict = {}

            def run(name: str, **kw) -> None:
                summaries: list = []
                t0 = time.perf_counter()
                got = client(name).run_gadget(
                    "trace", "exec", params, share=True, outputs=("summary",),
                    on_summary=lambda _n, s: summaries.append(s), **kw)
                res[name] = {"out": got, "summaries": summaries,
                             "seconds": time.perf_counter() - t0}

            owner = threading.Thread(target=run, args=(f"{run_id}-owner",), daemon=True,
                                     name=f"{run_id}-owner",
                                     kwargs={"run_id": run_id, "stop_event": stop,
                                             "stop_run": True, "keepalive": 5.0})
            threads = [owner]
            owner.start()
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline and not any(
                    r["run_id"] == run_id for r in probe.shared_runs("trace/exec")):
                time.sleep(0.05)
            if subscriber:
                sub = threading.Thread(target=run, args=(f"{run_id}-subscriber",), daemon=True,
                                       name=f"{run_id}-subscriber",
                                       kwargs={"subscriber": {"tier": "summary"}})
                threads.append(sub)
                sub.start()
            want_subs = 1 + subscriber
            while time.monotonic() < deadline:
                st = agent._streams.get(run_id)
                if st is not None and (st.done or (st.live_subscribers() >= want_subs
                                                   and stop_when(res))):
                    break
                time.sleep(0.02)
            stop.set()
            for t in threads:
                t.join(timeout=120.0)
                require(not t.is_alive(), f"agent run {run_id}: {t.name} never ended")
            return res

        # (a) 2-3: the shared run, the owner's stop after ~AGENT_BATCHES batches
        reset_launches()
        b0 = _source_batches()
        res = drive("smoke-shared", agent_params(batch), subscriber=True,
                    stop_when=lambda _r: _source_batches() - b0 >= AGENT_BATCHES)
        launched = read_launches()
        own, sub = res["smoke-shared-owner"], res["smoke-shared-subscriber"]
        for name, r in res.items():
            require(r["out"]["error"] is None, f"agent {name}: {r['out']['error']}")
        require(sub["out"]["attach"] and sub["out"]["attach"]["run_id"] == "smoke-shared"
                and sub["out"]["attach"]["shared"],
                f"agent: the compatible request did not attach: {sub['out']['attach']}")
        fo, fs = frames.get("smoke-shared-owner", []), frames.get("smoke-shared-subscriber", [])
        require(len(fo) == len(fs) == 1, f"agent: {len(fo)} and {len(fs)} final summaries")

        def without_seq(frame: bytes) -> bytes:
            h, p = decode(frame)
            return wire.encode_msg({k: v for k, v in h.items() if k != "seq"}, p)

        require(without_seq(fo[0]) == without_seq(fs[0]),
                "agent: the subscribers' final summary frames differ")
        final = own["summaries"][-1]
        events = int(final["events"])
        batches = events // batch
        require(events == batches * batch and batches >= AGENT_BATCHES,
                f"agent: final summary {events} events, not whole batches of {batch}")
        want_k2 = batches if device == "cuda" else 0
        require(launched == {"K1": 0, "K2": want_k2, "K3": 0},
                f"agent: launched {launched}, expected K2 {want_k2} (once a batch)")
        cpu = gadget_run("cpu", batches, batch)
        # the CPU's summary framed and read back as the agent's went
        want = wire.decode_summary(*wire.decode_msg(wire.encode_msg(
            *wire.encode_summary(cpu["summary"]))))
        gap = compare_wire_summaries(final, want, "agent run, card vs CPU", anomaly_rel=5e-2)
        ev_s = events / own["seconds"]
        out["shared"] = {"events": events, "batches": batches, "seconds": own["seconds"],
                         "ev_per_s": ev_s, "k2_launches": launched["K2"],
                         "ae_rel_gap": gap, "frame_bytes": len(fo[0]),
                         "local_ev_per_s": local_ev_per_s,
                         "grpc_overhead": local_ev_per_s / ev_s}
        log(f"[agent] (5j a) RunGadget trace/exec through the port's agent ({device}), shared "
            f"with a summary-tier subscriber, the owner's stop after {AGENT_BATCHES} popped "
            f"batches: {batches} x {batch} events in {own['seconds']:.2f} s, {ev_s:.0f} events/s "
            f"end to end against 5d(a)'s LocalRuntime {local_ev_per_s:.0f} in this run "
            f"(LocalRuntime / agent {local_ev_per_s / ev_s:.2f}x); K2 {launched['K2']} "
            f"launches (once a batch); both final summaries one {len(fo[0])}-byte frame but "
            f"for the seq; equal to the CPU's (distinct and entropy bit for bit, ae within "
            f"{gap:.3g} of a score)")

        # (a) 4: history a window a harvest, under a recording
        hist, cap = root / "hist", root / "capture"
        HISTORY.set_base_dir(str(hist))
        RECORDINGS.set_base_dir(str(cap))
        rec = probe.start_recording("smoke-rec")
        require(rec.get("ok"), f"agent: StartRecording {rec}")
        reset_launches()
        b0 = _source_batches()
        res = drive("smoke-history",
                    agent_params(batch, harvest_interval=AGENT_HARVEST, history="true",
                                 history_interval="0"),
                    subscriber=False,
                    stop_when=lambda r: _source_batches() - b0 >= AGENT_BATCHES)
        launched_h = read_launches()
        own = res["smoke-history-owner"]
        require(own["out"]["error"] is None, f"agent history run: {own['out']['error']}")
        stopped = probe.stop_recording("smoke-rec")
        require(stopped.get("ok"), f"agent: StopRecording {stopped}")
        harvests = len(own["summaries"])
        cum = [0] + [int(x["events"]) for x in own["summaries"]]
        sealing = sum(b > a for a, b in zip(cum, cum[1:]))  # a harvest with no new event seals none
        events_h = cum[-1]
        require(sealing >= 2, f"agent history run: {harvests} harvests, {sealing} with events")
        rows = probe.list_windows(gadget="trace/exec")["windows"]
        require(len(rows) == sealing and {r["node"] for r in rows} == {"n0"},
                f"agent: ListWindows {len(rows)} windows for {sealing} harvests with events")
        pushed = probe.query_windows(gadget="trace/exec")
        store = decode_frames(list(HISTORY.fetch_windows(base_dir=str(hist),
                                                         gadget="trace/exec", node="n0")))
        want_q = answer_query(store).to_dict()
        got_q = answer_query([pushed["window"]]).to_dict()
        require(pushed["folded"] == len(rows) and want_q["events"] == events_h,
                f"agent: QueryWindows folded {pushed['folded']} of {len(rows)} windows, "
                f"{want_q['events']} events of {events_h}")
        for k in ("events", "distinct", "entropy_bits", "heavy_hitters", "inv", "quantiles"):
            require(got_q[k] == want_q[k], f"agent: QueryWindows {k} differs from answer_query")
        fetched = probe.fetch_recording("smoke-rec", str(root / "bundle"))
        (jpath,) = list(iter_journals(str(root / "bundle")))
        reset_launches()
        t_rep = time.perf_counter()
        rp = replay_journal(jpath, device=device, param_overrides={
            "operator.tpusketch.history-dir": str(root / "rehist")})
        rep_s = time.perf_counter() - t_rep
        launched_r = read_launches()
        require(rp.digests_match and len(rp.recorded_digests) == harvests
                and rp.events == events_h,
                f"agent: replay of the fetched recording: digests_match {rp.digests_match}, "
                f"{len(rp.recorded_digests)} digests for {harvests} harvests, {rp.events} "
                f"events of {events_h}")
        state = probe.dump_state()
        done = {r["run_id"]: r for r in state["runs"] if r["shared"] and r["done"]}
        require("smoke-history" in done and isinstance(state.get("alerts"), list)
                and state.get("device") == str(agent.device),
                f"agent: DumpState runs {[r['run_id'] for r in state['runs']]}")
        k2_h = launched_h["K2"] + launched_r["K2"]
        out["history"] = {"events": events_h, "harvests": harvests, "windows": len(rows),
                          "seconds": own["seconds"], "recording": fetched,
                          "replay_s": rep_s, "replay_digests": len(rp.digests),
                          "k2_launches": k2_h, "dump_runs": sorted(done)}
        log(f"[agent] (5j a) the same run with a window a harvest ({AGENT_HARVEST}) under "
            f"StartRecording: {events_h} events, {harvests} harvests ({sealing} with events), "
            f"ListWindows {len(rows)} "
            f"windows, QueryWindows folded {pushed['folded']} equal to answer_query over the "
            f"store; fetch_recording {fetched['files']} files, {fetched['bytes']} bytes; "
            f"replay on the {device} {rep_s:.2f} s, every digest ({len(rp.digests)}) "
            f"reproduced; DumpState lists the finished shared runs {sorted(done)} and "
            f"{len(state['alerts'])} alerts; K2 {launched_h['K2']} + {launched_r['K2']} "
            f"(run + replay)")
        out["k2_launches"] = launched["K2"] + k2_h
    finally:
        client_mod.wire.decode_msg = decode
        for c in clients:
            c.close()
        server.stop(grace=2.0).wait(30.0)
        RECORDINGS.stop_all()
        RECORDINGS.set_base_dir(None)
        HISTORY.close_all()
        HISTORY.set_base_dir(None)
        shutil.rmtree(sock_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def agent_cli(device: str, batch: int, root: Path) -> dict:
    """Phase 5j (b): ``ig-tpu-torch agent --listen unix://<tmp>/b.sock
    --node-name n1 --device <device> --flight-record-path <root>/fr.json
    --metrics-addr 127.0.0.1:0`` as a subprocess (through AGENT_DRIVER,
    which times torch's import), ``agent liveness`` polled as a subprocess
    until it answers (AGENT_LIVENESS_S), one RunGadget paced at one batch
    a second that the client stops once the agent's /metrics counts
    AGENT_CLI_BATCHES popped batches (its summary must hold exactly those
    events), ``debug state --remote`` as a subprocess (exit 0), then
    SIGTERM: exit 0 within 30 s and the flight record written. ``debug
    state`` starts beside the RunGadget (each pays a fresh process's
    set-up; the agent's DumpState answers while it serves). The agent's
    stderr is printed if it dies. Runs on the CPU too."""
    import urllib.request

    from inspektor_gadget_tpu_torch.agent.client import AgentClient
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    sock_dir = Path(tempfile.mkdtemp(prefix="igtpu-smoke-"))
    target, fr = f"unix://{sock_dir}/b.sock", root / "fr.json"
    out_path, err_path = root / "agent.out", root / "agent.err"
    cwd = Path(__file__).resolve().parent
    cmd = [sys.executable, "-c", AGENT_DRIVER, "agent", "--listen", target, "--node-name", "n1",
           "--device", device, "--flight-record-path", str(fr), "--metrics-addr",
           "127.0.0.1:0"]
    t0 = time.perf_counter()
    with open(out_path, "w") as fo, open(err_path, "w") as fe:
        proc = subprocess.Popen(cmd, stdout=fo, stderr=fe, cwd=cwd)

    def died(what: str) -> None:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        print(f"chip_smoke: the agent's stderr:\n{err_path.read_text()[-4000:]}",
              file=sys.stderr)
        require(False, f"agent (5j b): {what} (exit {proc.returncode})")

    res: dict = {}
    dbg = None
    try:
        polls, live_s = 0, None
        while time.perf_counter() - t0 < AGENT_LIVENESS_S:
            if proc.poll() is not None:
                died("exited before it answered")
            polls += 1
            r = subprocess.run([sys.executable, "-m", "inspektor_gadget_tpu_torch.agent.main",
                                "liveness", "--target", target], capture_output=True,
                               text=True, timeout=60, cwd=cwd)
            if r.returncode == 0 and r.stdout.strip() == "ok":
                live_s = time.perf_counter() - t0
                break
            time.sleep(0.2)
        if live_s is None:
            died(f"no answer to liveness within {AGENT_LIVENESS_S:.0f} s")
        text = out_path.read_text()
        m = re.search(r"\[driver\] torch import ([\d.]+) s", text)
        port = re.search(r"metrics on http://127\.0\.0\.1:(\d+)/metrics", text)
        require(m is not None and port is not None and f"device: {device}" in text,
                f"agent (5j b): start-up lines missing: {text[-1000:]}")
        # the bounded CUDA probe before the first CUDA use, then the
        # doctor's start-up report (ROADMAP 19)
        probe = re.search(rf"^device platform: {device} \((.*); probe ([\d.]+)s\)$", text, re.M)
        require(probe is not None and "CAPTURE WINDOWS" in text and "\nGADGETS\n" in text
                and f"PLATFORM {device} (" in text and "\nSUMMARY " in text,
                f"agent (5j b): no probe line or start-up report: {text[:2000]}")
        log(f"[agent] (5j b) the agent's probe: {probe[1]} in {float(probe[2]):.2f} s; its "
            f"start-up report: {text.count(chr(10) + '  ')} rows, "
            f"{text[text.index(chr(10) + 'SUMMARY '):].splitlines()[1]}")
        metrics = f"http://127.0.0.1:{port[1]}/metrics"

        def scrape(name: str) -> float:
            body = urllib.request.urlopen(metrics, timeout=10).read().decode()
            mm = re.search(rf'^{name}\{{gadget="trace/exec"\}} ([\d.e+]+)$', body, re.M)
            return float(mm[1]) if mm else 0.0

        def popped() -> float:
            return scrape("ig_source_batches_total")

        c = AgentClient(target, "n1", rpc_deadline=120.0)
        stop, summaries = threading.Event(), []
        got: dict = {}
        t_run = time.perf_counter()
        th = threading.Thread(target=lambda: got.update(c.run_gadget(
            "trace", "exec", agent_params(batch, rate=str(batch)), outputs=("summary",),
            on_summary=lambda _n, s: summaries.append(s), stop_event=stop)), daemon=True)
        th.start()
        t_dbg = time.perf_counter()
        dbg = subprocess.Popen([sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main",
                                "debug", "state", "--remote", f"n1={target}"],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                               cwd=cwd)
        first_s = None
        while th.is_alive() and time.perf_counter() - t_run < 120.0:
            n = popped()
            if n and first_s is None:
                first_s = time.perf_counter() - t_run
            if n >= AGENT_CLI_BATCHES:
                break
            time.sleep(0.05)
        stop.set()
        th.join(timeout=120.0)
        c.close()
        run_s = time.perf_counter() - t_run
        if th.is_alive() or proc.poll() is not None:
            died("RunGadget never ended")
        require(got.get("error") is None and summaries
                and summaries[-1]["events"] == AGENT_CLI_BATCHES * batch,
                f"agent (5j b): RunGadget {got.get('error')}, summaries "
                f"{[s['events'] for s in summaries]}")
        steps = scrape("ig_tpusketch_steps_total")
        require(steps == AGENT_CLI_BATCHES, f"agent (5j b): {steps} sketch steps in the "
                                            f"agent's /metrics for {AGENT_CLI_BATCHES} batches")
        try:
            dbg_out, dbg_err = dbg.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            dbg.kill()
            dbg_out, dbg_err = dbg.communicate()
        dbg_s = time.perf_counter() - t_dbg
        require(dbg.returncode == 0 and dbg_out.startswith(f"=== n1 ({target}) ==="),
                f"agent (5j b): debug state exited {dbg.returncode}: {dbg_err[-2000:]}")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            died("SIGTERM: still running after 30 s")
        term_s = time.perf_counter() - t_term
        require(rc == 0 and fr.exists(), f"agent (5j b): SIGTERM exit {rc}, flight record "
                                         f"{'written' if fr.exists() else 'missing'}")
        record = json.loads(fr.read_text())
        require(record.get("facts", {}).get("node") == "n1",
                f"agent (5j b): flight record facts {record.get('facts')}")
        res = {"liveness_s": live_s, "liveness_polls": polls, "torch_import_s": float(m[1]),
               "probe_s": float(probe[2]), "probe_detail": probe[1],
               "run_s": run_s, "first_batch_s": first_s, "events": summaries[-1]["events"],
               "steps": steps,
               "debug_state_s": dbg_s,
               "sigterm_s": term_s, "flight_record_bytes": fr.stat().st_size}
        log(f"[agent] (5j b) ig-tpu-torch agent --device {device} as a subprocess: liveness "
            f"answered after {live_s:.2f} s ({polls} polls; torch's import in it "
            f"{float(m[1]):.2f} s); RunGadget of {AGENT_CLI_BATCHES} batches paced at one a "
            f"second {run_s:.2f} s (the first batch popped after {first_s or 0:.2f} s: the "
            f"run's set-up in a fresh process), summary events {summaries[-1]['events']}, "
            f"{steps:.0f} sketch steps in its /metrics; debug state --remote beside it: exit 0 "
            f"in {dbg_s:.2f} s of process; SIGTERM: exit 0 in {term_s:.2f} s, "
            f"flight record {fr.stat().st_size} bytes")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if dbg is not None and dbg.poll() is None:
            dbg.kill()
            dbg.communicate()
        shutil.rmtree(sock_dir, ignore_errors=True)
    return res


# phase 5k: the fan-out (ROADMAP 18b). (a) two of the port's AgentServers in
# this process, each an owner's shared run of 5d(a)'s stream with a window a
# harvest, folded through GrpcRuntime's summary tier and its query_history;
# (b) a local fleet of two `ig-tpu-torch agent` subprocesses (deploy_local)
# and the CLI's row route across it
FANOUT_BATCHES = 8   # each owner ends its run for all once its source has popped this many
FANOUT_SEEDS = {"n0": "7", "n1": "8"}
# (b)'s json-row route sends one EV_PAYLOAD_JSON message an event, so its
# batch is cut to 4096 (a 2**17 batch is 131072 messages, and its frame
# passes gRPC's 4 MiB cap); the sketch geometry stays at full width
FANOUT_CLI_ARGS = ("--source", "pysynthetic", "--batch-size", "4096", "--rate", "20000",
                   "--timeout", "3")
FANOUT_LIVENESS_S = 120.0


def _without(d: dict, *keys: str) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


def fanout_route(device: str, batch: int, root: Path, agent_ev_per_s: float) -> dict:
    """Phase 5k (a): `serve` twice in this process on `device` (nodes n0 and
    n1, unix sockets under a temp directory, the history store under it
    too). On each node an owner (`AgentClient`, share=True, outputs
    summary) runs `agent_params` (pysynthetic seed 7 on n0, 8 on n1, a
    harvest and a window every AGENT_HARVEST); `GrpcRuntime.subscribe_
    summaries` attaches one summary-tier subscriber a node, and each owner
    ends its run for all once its source has popped FANOUT_BATCHES
    batches (counted per run at the operator). Requires: no error on
    either node; K2 once a popped batch; each node's last subscriber
    summary its owner's final frame but for the seq;
    `GrpcRuntime.query_history` answered by pushdown on both nodes and
    equal to `answer_query` over `canonical_order` of both stores'
    windows read directly; n1's final summary equal to `gadget_run` of the
    same stream, batches, harvest points and seals on the CPU (distinct
    and entropy bit for bit, ae within 5%). Logs the fleet's events/s beside
    5j(a)'s single agent. Runs on the CPU too, at small sizes."""
    from inspektor_gadget_tpu_torch.agent import wire
    from inspektor_gadget_tpu_torch.agent.client import AgentClient
    from inspektor_gadget_tpu_torch.agent.service import serve
    from inspektor_gadget_tpu_torch.fleet import canonical_order
    from inspektor_gadget_tpu_torch.history import HISTORY, answer_query, decode_frames
    from inspektor_gadget_tpu_torch.operators.tpusketch import TpuSketchInstance
    from inspektor_gadget_tpu_torch.runtime import GrpcRuntime
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tmp = Path(tempfile.mkdtemp(prefix="igtpu-smoke-"))
    hist = tmp / "history"
    HISTORY.set_base_dir(str(hist))
    runs = {node: f"smoke-fanout-{node}" for node in FANOUT_SEEDS}
    popped: dict[str, int] = {}
    enrich = TpuSketchInstance.enrich_batch

    def counted(self, b) -> None:
        enrich(self, b)
        if b.count:
            popped[self.ctx.run_id] = popped.get(self.ctx.run_id, 0) + 1

    TpuSketchInstance.enrich_batch = counted
    t_phase = time.perf_counter()
    servers, agents, targets = [], {}, {}
    runtime = None
    out: dict = {}
    try:
        for node in FANOUT_SEEDS:
            targets[node] = f"unix://{tmp}/{node}.sock"
            server, agents[node] = serve(targets[node], node_name=node, device=device)
            servers.append(server)
        owners: dict = {}
        stops = {node: threading.Event() for node in FANOUT_SEEDS}

        def own(node: str) -> None:
            summaries: list = []
            c = AgentClient(targets[node], f"{node}-owner", rpc_deadline=120.0)
            try:
                got = c.run_gadget(
                    "trace", "exec",
                    {**agent_params(batch, harvest_interval=AGENT_HARVEST, history="true",
                                    history_interval="0"), "gadget.seed": FANOUT_SEEDS[node]},
                    run_id=runs[node], share=True, keepalive=5.0, outputs=("summary",),
                    on_summary=lambda _n, s: summaries.append(s), stop_event=stops[node],
                    stop_run=True)
            finally:
                c.close()
            owners[node] = {"out": got, "summaries": summaries, "end": time.perf_counter()}

        reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=own, args=(n,), daemon=True) for n in FANOUT_SEEDS]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not all(
                runs[n] in agents[n]._streams for n in FANOUT_SEEDS):
            time.sleep(0.01)
        runtime = GrpcRuntime(dict(targets))
        last: dict = {}
        subs: dict = {}
        sub = threading.Thread(target=lambda: subs.update(runtime.subscribe_summaries(
            gadget="trace/exec", on_summary=lambda n, s: last.__setitem__(n, s))), daemon=True)
        sub.start()
        while time.monotonic() < deadline and not all(
                agents[n]._streams[runs[n]].live_subscribers() >= 2 for n in FANOUT_SEEDS):
            time.sleep(0.01)
        attached = {n: agents[n]._streams[runs[n]].live_subscribers() for n in FANOUT_SEEDS}
        pending = set(FANOUT_SEEDS)
        while pending and time.monotonic() < deadline:
            for n in sorted(pending):
                if popped.get(runs[n], 0) >= FANOUT_BATCHES or agents[n]._streams[runs[n]].done:
                    stops[n].set()
                    pending.discard(n)
            time.sleep(0.005)
        for n in pending:
            stops[n].set()
        for t in threads + [sub]:
            t.join(timeout=120.0)
            require(not t.is_alive(), "fan-out (5k a): a stream never ended")
        launched = read_launches()
        wall = max(o["end"] for o in owners.values()) - t0
        require(attached == {n: 2 for n in FANOUT_SEEDS},
                f"fan-out (5k a): subscribers attached {attached}, expected the owner and one "
                f"summary-tier subscriber a node")
        per_node: dict = {}
        for node in FANOUT_SEEDS:
            own_out, sub_out = owners[node]["out"], subs.get(node, {"error": "no result"})
            require(own_out["error"] is None and sub_out.get("error") is None,
                    f"fan-out (5k a) {node}: owner {own_out['error']}, subscriber "
                    f"{sub_out.get('error')}")
            require(sub_out["attach"] and sub_out["attach"]["run_id"] == runs[node],
                    f"fan-out (5k a) {node}: the subscriber attached to {sub_out['attach']}")
            final = owners[node]["summaries"][-1]
            require(_without(last.get(node, {}), "seq") == _without(final, "seq"),
                    f"fan-out (5k a) {node}: the subscriber's last summary is not the owner's "
                    f"final frame")
            events = int(final["events"])
            batches = events // batch
            require(events == batches * batch and batches == popped[runs[node]]
                    and batches >= FANOUT_BATCHES,
                    f"fan-out (5k a) {node}: {events} events, {popped.get(runs[node])} popped "
                    f"batches of {batch}")
            per_node[node] = {"events": events, "batches": batches,
                              "harvests": len(owners[node]["summaries"]),
                              "frame_records": sub_out["records"]}
        total_batches = sum(v["batches"] for v in per_node.values())
        want_k2 = total_batches if device == "cuda" else 0
        require(launched == {"K1": 0, "K2": want_k2, "K3": 0},
                f"fan-out (5k a): launched {launched}, expected K2 {want_k2} (once a batch)")
        t_q = time.perf_counter()
        ans = runtime.query_history(gadget="trace/exec")
        query_s = time.perf_counter() - t_q
        HISTORY.close_all()
        direct = []
        for node in FANOUT_SEEDS:
            direct += decode_frames(list(HISTORY.fetch_windows(
                base_dir=str(hist), gadget="trace/exec", node=node)))
        want_q = answer_query(canonical_order(direct)).to_dict()
        got_q = ans.to_dict()
        require(got_q["paths"] == {n: "pushdown" for n in FANOUT_SEEDS} and not got_q["errors"],
                f"fan-out (5k a): query_history paths {got_q['paths']}, errors {got_q['errors']}")
        require(want_q["events"] == sum(v["events"] for v in per_node.values()),
                f"fan-out (5k a): the stores hold {want_q['events']} events")
        for k in ("events", "distinct", "entropy_bits", "heavy_hitters", "inv", "quantiles",
                  "nodes"):
            require(got_q[k] == want_q[k],
                    f"fan-out (5k a): query_history {k} differs from answer_query over the "
                    f"stores' windows in canonical order")
        n1 = owners["n1"]["summaries"]
        harvest_at = [int(s["events"]) // batch for s in n1[:-1]]
        # the same history plane: a seal resolves the names of its window's
        # heavy keys, so the summaries' `names` need the same seals
        cpu = gadget_run("cpu", per_node["n1"]["batches"], batch, seed=FANOUT_SEEDS["n1"],
                         harvest_at=harvest_at,
                         ops={"tpusketch": {"history": "true", "history-interval": "0",
                                            "history-dir": str(root / "cpu-history")}})
        want = wire.decode_summary(*wire.decode_msg(wire.encode_msg(
            *wire.encode_summary(cpu["summary"]))))
        gap = compare_wire_summaries(n1[-1], want, "fan-out n1, agent vs CPU",
                                     anomaly_rel=5e-2)
        ev_s = sum(v["events"] for v in per_node.values()) / wall
        out = {"nodes": per_node, "seconds": wall, "ev_per_s": ev_s, "k2_launches": launched["K2"],
               "agent_ev_per_s": agent_ev_per_s, "query_s": query_s,
               "query_windows": len(direct), "ae_rel_gap": gap, "harvest_at_n1": harvest_at}
        log(f"[fanout] (5k a) two agents in this process ({device}), each an owner's shared "
            f"run with a window a harvest ({AGENT_HARVEST}) and a summary-tier subscriber "
            f"through GrpcRuntime.subscribe_summaries: "
            + ", ".join(f"{n} {v['batches']} x {batch} events, {v['harvests']} harvests"
                        for n, v in per_node.items())
            + f"; {ev_s:.0f} events/s for the fleet ({wall:.2f} s) against 5j(a)'s single "
            f"agent {agent_ev_per_s:.0f} in this run ({ev_s / agent_ev_per_s:.2f}x); K2 "
            f"{launched['K2']} launches (once a batch); each subscriber's last summary the "
            f"owner's final frame but for the seq; query_history by pushdown on both nodes in "
            f"{query_s * 1e3:.1f} ms, equal to answer_query over the {len(direct)} stored "
            f"windows in canonical order; n1 equal to the CPU's gadget_run at the same "
            f"{len(harvest_at)} harvest points (distinct and entropy bit for bit, ae within "
            f"{gap:.3g} of a score)")
    finally:
        TpuSketchInstance.enrich_batch = enrich
        if runtime is not None:
            runtime.close()
        for server in servers:
            server.stop(grace=2.0).wait(30.0)
        HISTORY.close_all()
        HISTORY.set_base_dir(None)
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def fanout_cli(device: str, root: Path) -> dict:
    """Phase 5k (b): `deploy_local(2, device=device)` (the state file under a
    temp directory, free loopback ports) starts two ``ig-tpu-torch agent``
    subprocesses; ``agent liveness`` is polled until each answers
    (FANOUT_LIVENESS_S) and each serves one warm-up run up to its first
    harvest with events (a fresh agent's first run pays its CUDA context).
    Then ``ig-tpu-torch trace exec --remote node-0=...,node-1=...
    FANOUT_CLI_ARGS --tpusketch-enable true`` (GADGET_SKETCH, full width)
    ``-o json`` as a subprocess: exit 0, rows from both nodes, no PARTIAL
    label. Beside it, at the same time (5l d): ``fleet health --remote``,
    ``query --remote`` and ``query --remote --topology auto:2`` over the
    windows the warm-up runs sealed (a window a harvest, into a store
    under the temp directory): each exits 0, every agent healthy, the
    topology answer the flat one's (events, distinct, entropy, heavy
    hitters). `undeploy_local` must stop both, exit 0 within 30 s each.
    Runs on the CPU too."""
    from inspektor_gadget_tpu_torch.agent.client import AgentClient
    from inspektor_gadget_tpu_torch.agent.main import main as agent_main
    from inspektor_gadget_tpu_torch.cli import deploy as D
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tmp = Path(tempfile.mkdtemp(prefix="igtpu-smoke-"))
    state = str(tmp / "agents.json")
    cwd = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    prev_hist = os.environ.get("IG_HISTORY_DIR")
    os.environ["IG_HISTORY_DIR"] = str(tmp / "history")  # the agents' stores
    try:
        targets = D.deploy_local(2, device=device, path=state, log_dir=str(root / "logs"))
    finally:
        if prev_hist is None:
            os.environ.pop("IG_HISTORY_DIR", None)
        else:
            os.environ["IG_HISTORY_DIR"] = prev_hist
    res: dict = {}
    try:
        pids = json.loads(Path(state).read_text())["pids"]
        live: dict = {}
        while time.perf_counter() - t0 < FANOUT_LIVENESS_S and len(live) < len(targets):
            for node, target in targets.items():
                if node in live:
                    continue
                require(D._alive(pids[node]), f"fan-out (5k b): agent {node} exited: "
                        + (root / "logs" / f"{node}.log").read_text()[-2000:])
                with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
                        contextlib.redirect_stderr(null):
                    if agent_main(["liveness", "--target", target]) == 0:
                        live[node] = time.perf_counter() - t0
            time.sleep(0.2)
        require(len(live) == len(targets), f"fan-out (5k b): liveness answered for {live} "
                                           f"within {FANOUT_LIVENESS_S:.0f} s")
        warm: dict = {}

        def warm_up(node: str) -> None:
            stop, t = threading.Event(), time.perf_counter()

            def on_summary(_n, s) -> None:
                if s["events"]:
                    stop.set()

            c = AgentClient(targets[node], f"{node}-warm", rpc_deadline=120.0)
            timer = threading.Timer(120.0, stop.set)
            timer.daemon = True
            timer.start()
            try:
                got = c.run_gadget("trace", "exec",
                                   agent_params(4096, rate="20000", harvest_interval="300ms",
                                                history="true", history_interval="0"),
                                   outputs=("summary",), on_summary=on_summary, stop_event=stop)
            finally:
                timer.cancel()
                c.close()
            warm[node] = {"error": got["error"], "seconds": time.perf_counter() - t}

        threads = [threading.Thread(target=warm_up, args=(n,), daemon=True) for n in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=150.0)
        require(all(w["error"] is None for w in warm.values()) and len(warm) == len(targets),
                f"fan-out (5k b): warm-up runs {warm}")
        flags = [x for k, v in GADGET_SKETCH.items() for x in (f"--tpusketch-{k}", v)]
        spec = ",".join(f"{n}={t}" for n, t in targets.items())
        rows_path = root / "rows.json"
        cmd = [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main", "trace", "exec",
               "--remote", spec, *FANOUT_CLI_ARGS, "--tpusketch-enable", "true", *flags,
               "-o", "json"]
        cli_main = [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main"]
        query = [*cli_main, "query", "--remote", spec, "--gadget", "trace/exec", "-o", "json"]
        side: dict = {}
        beside = threading.Thread(target=lambda: side.update(run_at_once({
            "fleet health": [*cli_main, "fleet", "health", "--remote", spec, "-o", "json"],
            "query": query, "query --topology": [*query, "--topology", "auto:2"]},
            timeout=300)), daemon=True)
        t_cli = time.perf_counter()
        beside.start()
        with open(rows_path, "w") as fo:
            r = subprocess.run(cmd, stdout=fo, stderr=subprocess.PIPE, text=True, timeout=300,
                               cwd=cwd)
        cli_s = time.perf_counter() - t_cli
        beside.join(timeout=330)
        for name in ("fleet health", "query", "query --topology"):
            proc, _wall = side.get(name, (None, 0.0))
            require(proc is not None and proc.returncode == 0,
                    f"fleet tier (5l d): {name} --remote "
                    + (f"exited {proc.returncode}: {proc.stderr[-2000:]}" if proc is not None
                       else "did not exit in 300 s"))
        health = json.loads(side["fleet health"][0].stdout)["agents"]
        flat, tree = (json.loads(side[k][0].stdout) for k in ("query", "query --topology"))
        require(sorted(a["node"] for a in health if a["state"] == "healthy") == sorted(targets),
                f"fleet tier (5l d): fleet health {health}")
        require(flat["windows"] >= len(targets) and flat["events"] > 0
                and all(tree[k] == flat[k] for k in ("events", "distinct", "entropy_bits",
                                                     "heavy_hitters"))
                and tree["fleet"]["depth"] == 1,
                f"fleet tier (5l d): the topology answer {[tree[k] for k in ('windows', 'events')]}"
                f" differs from the flat one {[flat[k] for k in ('windows', 'events')]}")
        fleet_cli = {name: side[name][1] for name in side}
        nodes: dict = {}
        with open(rows_path) as f:
            for line in f:
                if line.startswith("{"):
                    node = json.loads(line)["node"]
                    nodes[node] = nodes.get(node, 0) + 1
        require(r.returncode == 0 and set(nodes) == set(targets) and "PARTIAL" not in r.stderr,
                f"fan-out (5k b): trace exec --remote exited {r.returncode}, rows by node "
                f"{nodes}, stderr {r.stderr[-2000:]}")
        t_un = time.perf_counter()
        stopped = D.undeploy_local(state, wait=30.0)
        undeploy_s = time.perf_counter() - t_un
        codes = {n: D.EXIT_CODES.get(n) for n in targets}
        require(sorted(stopped) == sorted(targets) and all(c == 0 for c in codes.values()),
                f"fan-out (5k b): undeploy stopped {stopped}, exit codes {codes}")
        res = {"liveness_s": live, "warm_up": warm, "cli_s": cli_s, "rows": nodes,
               "undeploy_s": undeploy_s, "rows_bytes": rows_path.stat().st_size,
               "fleet_cli": {"wall_s": fleet_cli, "windows": flat["windows"],
                             "events": flat["events"]}}
        log(f"[fanout] (5k b) deploy_local(2, device={device}): liveness after "
            + ", ".join(f"{n} {s:.2f} s" for n, s in live.items())
            + "; warm-up runs to a first harvest "
            + ", ".join(f"{n} {w['seconds']:.2f} s" for n, w in warm.items())
            + f"; trace exec --remote {' '.join(FANOUT_CLI_ARGS)} -o json at full sketch width: "
            f"exit 0 in {cli_s:.2f} s of process, rows {nodes}, no PARTIAL label; "
            f"undeploy_local: both exit 0 in {undeploy_s:.2f} s")
        log(f"[shard] (5l d) beside that run, at once: fleet health --remote (both agents "
            f"healthy), query --remote and query --remote --topology auto:2 over the warm-up "
            f"runs' {flat['windows']} windows: exit 0 in "
            + ", ".join(f"{k} {v:.2f} s" for k, v in fleet_cli.items())
            + f" of process; the topology answer equals the flat one (events {flat['events']}, "
            f"distinct ~{flat['distinct']:.0f}, entropy {flat['entropy_bits']:.4f} b, "
            f"{len(flat['heavy_hitters'])} heavy hitters), merge tree depth "
            f"{tree['fleet']['depth']}")
    finally:
        if Path(state).exists():
            with contextlib.suppress(TimeoutError):
                D.undeploy_local(state, wait=30.0)
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# phase 5l: sharded ingest, the collective merge and the fleet tier. The
# heavy-hitter vocabulary stays under top-k's 128, where the streaming
# candidate set is exact on every path (tests/test_torch_sharded_ingest.py):
# above k the table is an approximation on the single-lane path too, and
# the lanes' union at harvest may keep other candidates
SHARD_BATCHES = 24
SHARD_MID = 13          # the mid-run harvest: after this batch, mid-round at 2 and 4 lanes
SHARD_LANES = (1, 2, 4)
SHARD_VOCAB = 100
SHARD_OP_BATCHES = 16
SHARD_OP_HARVEST_AT = [7]
# the collective merge over a one-rank NCCL group, in a process of its own
# (so a hung NCCL init costs its timeout, not the script): two lane rows
# on cuda:0 at the production geometry, merged by `make_fleet_merge` over
# the group and by `cluster_merge` in the process; both digests dumped
NCCL_MERGE_SCRIPT = """\
import json, sys, time
t0 = time.perf_counter()
dump, port, seed, device = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
import numpy as np
import torch
import torch.distributed as dist
from inspektor_gadget_tpu_torch.fleet.collective import bundle_digest, make_fleet_merge
from inspektor_gadget_tpu_torch.ops import sketches as S
from inspektor_gadget_tpu_torch.parallel.cluster import cluster_merge
from inspektor_gadget_tpu_torch.parallel.distributed import (init_distributed,
                                                            make_multihost_mesh)
from inspektor_gadget_tpu_torch.sources import ZipfFoldedSource
from inspektor_gadget_tpu_torch.sources.synthetic import DIST, DISTINCT, HH, VALUES, WEIGHTS
dev = torch.device(device)
if dev.type == "cuda":
    torch.cuda.set_device(dev)
t_import = time.perf_counter()
init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev, timeout_s=120)
t_init = time.perf_counter()
mesh = make_multihost_mesh(devices=[dev, dev])
src = ZipfFoldedSource(seed, vocab=100)
rows = []
for d in mesh:
    b = S.bundle_init(**S.PRODUCTION_GEOMETRY, device=d)
    h = torch.from_numpy(src.generate(1 << 17).view(np.int32)).to(d)
    S.bundle_ingest_step(b, h[HH], h[DISTINCT], h[DIST], h[WEIGHTS], 3.0, h[VALUES])
    rows.append(b)
t_merge = time.perf_counter()
merged = make_fleet_merge(dist.group.WORLD)(rows)
if dev.type == "cuda":
    torch.cuda.synchronize()
merge_s = time.perf_counter() - t_merge
out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
       "digest": bundle_digest(merged), "want": bundle_digest(cluster_merge(rows)),
       "events": float(merged.events), "import_s": t_import - t0, "init_s": t_init - t_import,
       "merge_ms": merge_s * 1e3}
dist.destroy_process_group()
with open(dump, "w") as f:
    json.dump(out, f)
"""


def dealt_rounds(batches: int, chips: int, harvest_at: list[int]) -> int:
    """The sharded steps the operator's dealing runs for `batches` batches
    over `chips` lanes with a harvest after each batch in `harvest_at` and
    one at the end: a round a full set of lanes, plus one a harvest that
    finds a round open (its empty lanes ride zero-weight fillers)."""
    rounds, pending = 0, 0
    for i in range(1, batches + 1):
        pending += 1
        if pending == chips:
            rounds, pending = rounds + 1, 0
        if i in harvest_at and pending:
            rounds, pending = rounds + 1, 0
    return rounds + (1 if pending else 0)


def shard_lanes(device: str, batch: int, geom: dict, seed: int) -> dict:
    """Phase 5l(a): SHARD_BATCHES seeded zipf batches (heavy hitters of
    SHARD_VOCAB keys; ragged tails; drops) pre-staged on `device`, dealt
    round-robin over 1, 2 and 4 lanes on [`device`] * n through
    `make_bundle_ingest_sharded`, harvested (`make_bundle_harvest_sharded`)
    after batch SHARD_MID, flushing the open round with zero-weight
    fillers, and at the end. Every merged leaf and the digest's bytes must
    equal the single-lane `bundle_ingest_step` fold of the same prefix on
    `device` and on the CPU; K2 must launch once a lane a round. Then the
    device-only events/s of 4-lane rounds against 1-lane ones over the
    same staged batches, and the harvest merge's ms. Runs on the CPU too."""
    from inspektor_gadget_tpu_torch.ops import sketches as S
    from inspektor_gadget_tpu_torch.parallel.mesh import ingest_mesh
    from inspektor_gadget_tpu_torch.sources import ZipfFoldedSource
    from inspektor_gadget_tpu_torch.sources.synthetic import (DIST, DISTINCT, HH, LANES, VALUES,
                                                              WEIGHTS)
    dev = torch.device(device)
    src = ZipfFoldedSource(seed, vocab=SHARD_VOCAB)
    host = [src.generate(batch, valid=batch - 977 * (i % 3)) for i in range(SHARD_BATCHES)]
    drops = [float(i % 5) for i in range(SHARD_BATCHES)]
    staged = [torch.from_numpy(h.view(np.int32)).to(dev) for h in host]
    events = [int(h[WEIGHTS].sum()) for h in host]

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def fold(where: torch.device, lanes: list) -> tuple:
        b, mid = S.bundle_init(**geom, device=where), None
        for i, x in enumerate(lanes):
            S.bundle_ingest_step(b, x[HH], x[DISTINCT], x[DIST], x[WEIGHTS], drops[i], x[VALUES])
            if i + 1 == SHARD_MID:
                mid = S.bundle_map(torch.clone, b)
        return mid, b

    t0 = time.perf_counter()
    dev_mid, dev_end = fold(dev, staged)
    sync()
    t1 = time.perf_counter()
    cpu_mid, cpu_end = fold(torch.device("cpu"),
                            [torch.from_numpy(h.view(np.int32)) for h in host])
    cpu_fold_s = time.perf_counter() - t1
    want = {"mid": (dev_mid, cpu_mid), "end": (dev_end, cpu_end)}

    def sharded(n: int):
        mesh = ingest_mesh(n, [dev] * n)
        like = S.bundle_init(**geom, device=dev)
        return (S.make_bundle_ingest_sharded(mesh, like), S.make_bundle_harvest_sharded(mesh, like),
                S.bundle_stack_sharded(like, mesh))

    zero = torch.zeros((LANES, batch), dtype=torch.int32, device=dev)

    def run_round(step, lanes, rnd: list) -> None:
        step(lanes, [x[HH] for x, _ in rnd], [x[DISTINCT] for x, _ in rnd],
             [x[DIST] for x, _ in rnd], [x[WEIGHTS] for x, _ in rnd], [d for _, d in rnd],
             [x[VALUES] for x, _ in rnd])

    out: dict = {"cpu_fold_s": cpu_fold_s, "lanes": {}}
    for n in SHARD_LANES:
        step, harvest, lanes = sharded(n)
        pending: dict = {}
        nxt, rounds, got = 0, 0, {}

        def flush() -> None:
            nonlocal rounds, pending
            if pending:
                run_round(step, lanes, [pending.get(k, (zero, 0.0)) for k in range(n)])
                rounds, pending = rounds + 1, {}

        reset_launches()
        for i, x in enumerate(staged):
            pending[nxt], nxt = (x, drops[i]), (nxt + 1) % n
            if len(pending) == n:
                flush()
            if i + 1 == SHARD_MID:
                flush()
                got["mid"] = harvest(lanes)
        flush()
        got["end"] = harvest(lanes)
        launched = read_launches()
        require(rounds == dealt_rounds(SHARD_BATCHES, n, [SHARD_MID]),
                f"sharded ingest (5l a), {n} lanes: {rounds} rounds")
        want_k2 = rounds * n if dev.type == "cuda" else 0
        require(launched == {"K1": 0, "K2": want_k2, "K3": 0},
                f"sharded ingest (5l a), {n} lanes: launched {launched}, expected K2 {want_k2} "
                f"(once a lane a round, {rounds} rounds)")
        for point in ("mid", "end"):
            g = S.bundle_to_numpy(got[point])
            gd = S.bundle_digest(got[point]).cpu().numpy().tobytes()
            for ref, where in zip(want[point], (device, "cpu")):
                r = S.bundle_to_numpy(ref)
                bad = [i for i, (a, b) in enumerate(zip(g, r))
                       if a.dtype != b.dtype or not np.array_equal(a, b)]
                require(len(g) == len(r) and not bad,
                        f"sharded ingest (5l a), {n} lanes, {point} harvest: leaves {bad} differ "
                        f"from the single-lane fold on the {where}")
                require(gd == S.bundle_digest(ref).cpu().numpy().tobytes(),
                        f"sharded ingest (5l a), {n} lanes, {point} harvest: digest bytes differ "
                        f"from the single-lane fold on the {where}")
        out["lanes"][n] = {"rounds": rounds, "k2_launches": launched["K2"]}

    # device-only events/s: the same staged batches as 1-lane and as
    # 4-lane rounds, after a warm-up round each; and the harvest's merge
    timing: dict = {}
    for n in (1, 4):
        step, harvest, lanes = sharded(n)
        run_round(step, lanes, [(staged[k], 0.0) for k in range(n)])
        sync()
        t = time.perf_counter()
        for r0 in range(0, SHARD_BATCHES, n):
            run_round(step, lanes, [(staged[r0 + k], 0.0) for k in range(n)])
        sync()
        dt = time.perf_counter() - t
        merge_ms = []
        for _ in range(10):
            sync()
            t = time.perf_counter()
            harvest(lanes)
            sync()
            merge_ms.append((time.perf_counter() - t) * 1e3)
        timing[n] = {"ev_per_s": sum(events) / dt, "merge_ms": statistics.median(merge_ms)}
    out["timing"] = timing
    out["fold_s"] = t1 - t0
    log(f"[shard] (5l a) {SHARD_BATCHES} zipf batches of {batch} (heavy hitters of {SHARD_VOCAB} "
        f"keys, ragged tails, drops), every plane, dealt over "
        + ", ".join(f"{n} lane(s) ({d['rounds']} rounds, K2 {d['k2_launches']})"
                    for n, d in out["lanes"].items())
        + f" on [{device}] * n, harvested after batch {SHARD_MID} (mid-round at 2 and 4) and at "
        f"the end: every leaf and the digest's bytes equal the single-lane bundle_ingest_step fold "
        f"on the {device} and on the CPU ({cpu_fold_s:.2f} s)")
    log(f"[shard] (5l a) device-only, the same staged batches: 4-lane rounds "
        f"{timing[4]['ev_per_s']:.0f} events/s against 1-lane {timing[1]['ev_per_s']:.0f} "
        f"({timing[4]['ev_per_s'] / timing[1]['ev_per_s']:.2f}x; the lanes share one {device}); "
        f"the harvest merge {timing[4]['merge_ms']:.2f} ms at 4 lanes, {timing[1]['merge_ms']:.2f} "
        f"ms at 1 (host clock, median of 10, ending in a synchronize)")
    return out


def shard_operator(device: str, batch: int) -> dict:
    """Phase 5l(b): the operator's shard plane. Unpatched, on a one-card
    host ``shard-ingest true`` must raise the one-device ParamError, and
    with ``chips 2`` the "exceeds the 1 local device(s)" one. Then
    `_lane_devices` patched to two lanes on `device`:
    5d(a)'s `gadget_run` (heavy hitters of SHARD_VOCAB keys) for
    SHARD_OP_BATCHES batches with ``--tpusketch-shard-ingest true
    --tpusketch-chips 2`` and a harvest after batch 7 (mid-round), and the
    same stream unsharded: summaries equal (estimates bit for bit, ae
    within 5%), K2 once a lane a round. Runs on the CPU too."""
    from inspektor_gadget_tpu_torch.operators import tpusketch as P
    from inspektor_gadget_tpu_torch.params import ParamError
    cards = torch.cuda.device_count() if device == "cuda" else 1
    refused = {}
    for chips, said in (("auto", "this host exposes 1 device"),
                        ("2", "exceeds the 1 local device(s)")):
        try:
            P.TpuSketchInstance(P.SketchConfig(shard_ingest=True, chips=chips),
                                P.SketchContext(), device=device).post_gadget_run()
        except ParamError as e:
            refused[chips] = str(e)
        if cards == 1:
            require(said in refused.get(chips, ""),
                    f"shard-ingest, chips {chips}, on a one-card host (5l b): "
                    f"{refused.get(chips, 'no ParamError')}")
        else:
            require(not refused, f"shard-ingest on a {cards}-card host (5l b): {refused}")
    lane = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    real = P._lane_devices
    P._lane_devices = lambda chips, dev: [lane] * (chips if chips is not None else 2)
    try:
        reset_launches()
        sharded = gadget_run(device, SHARD_OP_BATCHES, batch, vocab=str(SHARD_VOCAB),
                             harvest_at=SHARD_OP_HARVEST_AT,
                             ops={"tpusketch": {"shard-ingest": "true", "chips": "2"}})
        launched = read_launches()
    finally:
        P._lane_devices = real
    plain = gadget_run(device, SHARD_OP_BATCHES, batch, vocab=str(SHARD_VOCAB),
                       harvest_at=SHARD_OP_HARVEST_AT)
    rounds = dealt_rounds(SHARD_OP_BATCHES, 2, SHARD_OP_HARVEST_AT)
    want_k2 = 2 * rounds if device == "cuda" else 0
    require(launched == {"K1": 0, "K2": want_k2, "K3": 0},
            f"the operator's shard plane (5l b): launched {launched}, expected K2 {want_k2} "
            f"(2 lanes x {rounds} rounds)")
    gap = max(compare_summaries(g, w, f"sharded vs unsharded run (5l b), harvest {i + 1}",
                                anomaly_rel=5e-2)
              for i, (g, w) in enumerate(zip(sharded["summaries"], plain["summaries"])))
    s = sharded["summary"]
    log(f"[shard] (5l b) shard-ingest true, unpatched on this {cards}-card host: "
        + ("; ".join(f"chips {k}: ParamError ({v})" for k, v in refused.items()) if refused
           else "accepted")
        + f"; with _lane_devices patched to [{lane}, {lane}] (two lanes sharing one card: a "
        f"check, not a deployment), LocalRuntime trace/exec, pysynthetic seed 7, vocab "
        f"{SHARD_VOCAB}, {SHARD_OP_BATCHES} x {batch}, every plane, a harvest after batch "
        f"{SHARD_OP_HARVEST_AT[0]}: {sharded['ev_per_s']:.0f} events/s against "
        f"{plain['ev_per_s']:.0f} unsharded; K2 {launched['K2']} ({rounds} rounds of 2 lanes); "
        f"both summaries equal the unsharded run's (events {s.events}, distinct ~{s.distinct:.0f}, "
        f"entropy {s.entropy_bits:.4f} b, ae within {gap:.3g} of a score)")
    return {"refused": refused, "cards": cards, "k2_launches": launched["K2"], "rounds": rounds,
            "ev_per_s": sharded["ev_per_s"], "plain_ev_per_s": plain["ev_per_s"],
            "ae_rel_gap": gap}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_nccl_merge(device: str, root: Path, seed: int) -> tuple:
    """Phase 5l(c), started: NCCL_MERGE_SCRIPT in a process of its own on a free
    loopback port (gloo on the CPU). `finish_nccl_merge` reads it."""
    root.mkdir(parents=True, exist_ok=True)
    dump = root / "chip_smoke_nccl.json"
    dump.unlink(missing_ok=True)
    cmd = [sys.executable, "-c", NCCL_MERGE_SCRIPT, str(dump), str(free_port()), str(seed),
           "cuda:0" if device == "cuda" else "cpu"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=Path(__file__).resolve().parent)
    return proc, dump, time.perf_counter()


def finish_nccl_merge(started: tuple, timeout: float = 240.0) -> dict:
    """Phase 5l(c): the one-rank group's `make_fleet_merge` digest must equal
    `cluster_merge`'s over the same two lane rows."""
    proc, dump, t0 = started
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        require(False, f"the collective merge (5l c) ran past {timeout:.0f} s")
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"the collective merge (5l c) exited {proc.returncode}: "
                                  f"{err[-2000:]}")
    res = json.loads(dump.read_text())
    require(res["world"] == 1 and res["digest"] == res["want"]
            and res["events"] == 2 * (1 << 17),
            f"the collective merge (5l c): {res}")
    log(f"[shard] (5l c) a one-rank {res['backend']} group on tcp://127.0.0.1 (init "
        f"{res['init_s']:.2f} s, torch's import {res['import_s']:.2f} s, {wall:.1f} s of "
        f"process): make_fleet_merge over 2 lane rows at the production geometry ({res['merge_ms']:.1f} "
        f"ms: SUM on int32, int64 and float32, MAX on the int32 HLL registers, all_gather of the "
        f"top-k candidates), its bundle_digest equal to cluster_merge's ({res['digest'][:16]}...). "
        f"Two ranks cannot share one card under NCCL (duplicate GPU): the two-rank merge is the "
        f"gloo test on the CPU (tests/test_torch_fleet_collective.py)")
    return {**res, "wall_s": wall}



# phase 5m: the doctor, the bounded CUDA probe and the stress harnesses
# (ROADMAP 19, 21); phase 5n: training-side parallelism over lanes of
# cuda:0 (ROADMAP 13)
DOCTOR_WINDOWS = {"fanotify_supported": "fanotify", "audit_supported": "audit",
                  "captrace_supported": "captrace", "fstrace_supported": "fstrace",
                  "sockstate_supported": "sockstate", "sigtrace_supported": "sigtrace",
                  "tcpinfo_supported": "tcpinfo", "blktrace_supported": "blktrace",
                  "perf_supported": "perf"}
STRESS = (("ring_stress", False), ("ring_stress", True), ("source_stress", False),
          ("source_stress", True))


def stress_harnesses() -> dict:
    """The stress harnesses this host can build: plain, and under
    ThreadSanitizer where g++ takes it; source_stress only as root (it
    opens the kernel windows)."""
    from inspektor_gadget_tpu_torch import native
    cxx = native.cxx_path()
    tsan = bool(cxx) and native.tsan_supported(cxx)
    return {(n, t): native.StressHarness(n, t) for n, t in STRESS
            if (tsan or not t) and (n != "source_stress" or os.geteuid() == 0)}


def doctor_phase(facts: dict, stress: dict) -> dict:
    """Phase 5m. (a) ``ig-tpu-torch doctor`` and ``doctor -o json`` as
    subprocesses at once: the same exit code, 1 if and only if a gadget
    is unavailable (the card's host lacks most kernel windows, so 1 is
    expected and is no failure); every window host_facts() also probes
    through the capture library agrees with the doctor's row; the
    gadget rows are the catalog's 30 gadgets; the toolchain row names
    nvcc with sm_90a; in this process (CUDA initialised) the topology row
    names the card. (b) `platform_probe.acquire_platform("cuda")` names
    torch's card with compute capability 9.0. (c) The stress harnesses,
    each g++ started at once, plain and under ThreadSanitizer, run to
    exit 0; a TSAN build this host's g++ rejects is logged as absent and
    must be what the doctor's toolchain row says, and source_stress,
    which opens the kernel windows, needs root. `stress` holds the
    harnesses phase 2 built (`stress_harnesses`)."""
    from inspektor_gadget_tpu_torch import doctor as PD
    from inspektor_gadget_tpu_torch.runtime.runtime import build_catalog
    from inspektor_gadget_tpu_torch.utils import platform_probe
    out: dict = {}
    cli = [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main", "doctor"]
    t0 = time.perf_counter()
    runs = run_at_once({"table": cli, "json": cli + ["-o", "json"]}, timeout=300)
    for name, (proc, secs) in runs.items():
        require(proc is not None and proc.returncode in (0, 1),
                f"doctor (5m a) {name}: {'timed out' if proc is None else proc.returncode} "
                f"{'' if proc is None else proc.stderr[-2000:]}")
        out[f"{name}_s"] = secs
    doc = json.loads(runs["json"][0].stdout)
    table = runs["table"][0].stdout
    unavailable = [f"{g['category']}/{g['name']}" for g in doc["gadgets"]
                   if g["status"] == "unavailable"]
    rc = runs["json"][0].returncode
    require(rc == runs["table"][0].returncode == (1 if unavailable else 0),
            f"doctor (5m a): exit {rc} / {runs['table'][0].returncode} with "
            f"{len(unavailable)} unavailable gadget(s)")
    require(all(h in table for h in ("CAPTURE WINDOWS", "GADGETS", "PLATFORM", "SUMMARY")),
            f"doctor (5m a): the table lacks a section: {table[-1500:]}")
    disagree = {probe: (facts[probe], doc["windows"][w]["ok"])
                for probe, w in DOCTOR_WINDOWS.items() if facts[probe] != doc["windows"][w]["ok"]}
    require(not disagree, f"doctor (5m a): windows disagree with host_facts: {disagree}")
    rows = [(g["category"], g["name"]) for g in doc["gadgets"]]
    catalog = [(g["category"], g["name"]) for g in build_catalog()["gadgets"]]
    require(rows == catalog and len(rows) == 30,
            f"doctor (5m a): gadget rows {len(rows)} against the catalog's {len(catalog)}")
    tool = doc["windows"]["native_toolchain"]
    require("nvcc present with sm_90a" in tool["detail"],
            f"doctor (5m a): toolchain row {tool}")
    topo = PD._probe_device_topology()
    require(topo.ok and topo.detail.startswith(f"{torch.cuda.device_count()} local cuda device(s)")
            and "cc 9.0" in topo.detail, f"doctor (5m a): topology row {topo}")
    counts: dict = {}
    for g in doc["gadgets"]:
        counts[g["status"]] = counts.get(g["status"], 0) + 1
    down = sorted(w for w, v in doc["windows"].items() if not v["ok"])
    out.update(rc=rc, unavailable=unavailable, counts=counts, windows_down=down,
               toolchain=tool["detail"], topology=topo.detail,
               host_facts_vs_doctor={w: facts[p] for p, w in DOCTOR_WINDOWS.items()},
               kmsg={"host_facts": facts["kmsg_readable"], "doctor": doc["windows"]["kmsg"]},
               ptrace={"host_facts": facts["ptrace"], "doctor": doc["windows"]["ptrace"]})
    log(f"[doctor] (5m a) doctor and doctor -o json as subprocesses: exit {rc} "
        f"({runs['table'][1]:.2f} s, {runs['json'][1]:.2f} s of process); gadgets {counts}; "
        f"unavailable: {', '.join(unavailable) or 'none'}; windows down: {', '.join(down)}; "
        f"the {len(DOCTOR_WINDOWS)} windows host_facts() probes agree; kmsg host_facts "
        f"{facts['kmsg_readable']} / doctor {doc['windows']['kmsg']['ok']}, ptrace "
        f"{facts['ptrace']} / {doc['windows']['ptrace']['ok']}")
    log(f"[doctor] (5m a) toolchain: {tool['detail']}; topology (this process): {topo.detail}")
    # (b) the bounded probe, in this process
    acq = platform_probe.acquire_platform("cuda")
    dev0 = acq["devices"][0]
    require(acq["ok"] and dev0["name"] == torch.cuda.get_device_name(0) and dev0["cc"] == "9.0"
            and len(acq["devices"]) == torch.cuda.device_count(),
            f"doctor (5m b): the probe found {acq['devices']}")
    out["probe"] = {"detail": acq["detail"], "elapsed_s": acq["elapsed"]}
    log(f"[doctor] (5m b) acquire_platform('cuda'): {acq['detail']} ({acq['elapsed']:.2f} s "
        f"with the child's start; no torch in it)")
    # (c) the stress harnesses, built with the kernels (phase 2), run at once
    if not any(t for _, t in stress):
        require("no -fsanitize=thread" in tool["detail"],
                f"stress (5m c): no TSAN build, but the toolchain row says {tool}")
        log("[stress] (5m c) this host's g++ rejects -fsanitize=thread: the TSAN builds are "
            f"absent (the doctor's toolchain row: {tool['detail']})")
    if not any(n == "source_stress" for n, _ in stress):
        log("[stress] (5m c) not root: source_stress cannot open the kernel windows, not run")
    labels = {f"{n}{' (tsan)' if t else ''}": h for (n, t), h in stress.items()}
    runs = run_at_once({label: [str(h.build())] for label, h in labels.items()}, timeout=600)
    out["stress"] = {}
    for label, h in labels.items():
        r, run_s = runs[label]
        name = label.split()[0]
        require(r is not None and r.returncode == 0 and f"{name.replace('_', ' ')} OK" in r.stdout,
                f"stress (5m c) {label}: "
                f"{'timed out' if r is None else f'exit {r.returncode}'}\n"
                f"{'' if r is None else (r.stdout + r.stderr)[-3000:]}")
        last = r.stdout.strip().splitlines()[-2:]
        out["stress"][label] = {"build_s": h.build_seconds, "run_s": run_s, "last": last}
        log(f"[stress] (5m c) {label}: g++ {h.build_seconds:.1f} s (phase 2), run {run_s:.2f} s "
            f"beside the others, exit 0: {' | '.join(last)}")
    out["seconds"] = time.perf_counter() - t0
    return out


PAR_ROWS = 16            # seq windows a train step (4 a lane over 4 lanes)
PAR_STEPS = 3            # train steps a comparison
PAR_MEMORY_STEPS = 8     # the EP step over 4 lanes: memory read after step 2 and this one
PAR_TOKENS = 8192        # make_ep_moe's tokens
PAR_RING = (16, 4096, 4, 32)
PAR_RING_CPU_B = 4       # the CPU's ring check keeps T, H, D and takes 4 of the 16 rows
PAR_PP = (4, 8, 256)     # stages, microbatches, rows a microbatch (d_model 128, d_ff 256)
PAR_AE_ROWS = 128        # count rows a node lane, a step
PAR_TOL = 2e-2           # bf16 matmuls: card against the one-lane path and the CPU
PAR_LOSS_TOL = 1e-3      # a train step's loss, every step, against the run it is held to
PAR_GRAD_TOL = 5e-2      # the first step's gradient, of its leaf's largest (bf16 gradients)
PAR_ZERO = 1e-4          # a gradient this share of its leaf's largest is zero up to rounding
PAR_UPDATE_TOL = 0.05    # the first step's update: within this share of lr ...
PAR_FLIP_SHARE = 1e-2    # ... but for this share of a leaf's elements (bf16 sign rounding),
PAR_FLIP_FLOOR = 4       # or this many in a small leaf


def _flat(tree) -> dict[str, np.ndarray]:
    from inspektor_gadget_tpu_torch.models.params import _flatten
    return {k: np.array(v, dtype=np.float32) for k, v in _flatten(tree).items()}


def _first_moment(scorer) -> dict[str, np.ndarray]:
    """Adam's first moment of every weight by name, (1 - beta1) g after
    one step: the gradient of that step, up to the factor."""
    from inspektor_gadget_tpu_torch.models import autoencoder as AE
    if isinstance(scorer, AE.TPScorer):
        return _flat(AE.ae_gather_tp(scorer, "exp_avg"))
    return {name: scorer.opt.state[p]["exp_avg"].detach().float().cpu().numpy()
            for name, p in scorer.model.named_parameters()}


def _zero_by_construction(name: str, shape: tuple) -> np.ndarray:
    """The elements whose gradient is zero in exact arithmetic: the
    attention's key bias (a softmax row is the same when one constant is
    added to all its scores), the middle third of a ``qkv.b``."""
    mask = np.zeros(shape, dtype=bool)
    if name.endswith("qkv.b"):
        mask[shape[0] // 3:2 * shape[0] // 3] = True
    return mask


def _update_agrees(before: dict, got: dict, want: dict, got_m: dict, want_m: dict,
                   lr: float, what: str) -> dict:
    """The first train step of a card run, held against the run it is
    compared with, both from the weights `before`. The gradient: each
    run's Adam first moment after the step (`got_m`, `want_m`) agrees
    within PAR_GRAD_TOL of its leaf's largest. The update ``after -
    before``: Adam's first step moves an element by lr g / (|g| + eps),
    about lr times the sign of its gradient whatever the gradient's
    size, so the two agree to rounding wherever the gradient is clearly
    non-zero. Every element whose gradient is 0, or above PAR_ZERO of its
    leaf's largest in magnitude, and not zero by construction, agrees
    within PAR_UPDATE_TOL * lr, but for at most PAR_FLIP_SHARE of a
    leaf's such elements or PAR_FLIP_FLOOR of them, whichever is more (a
    bf16 gradient that rounds to the other sign); every element within
    Adam's bound 2 lr. A skipped
    or reversed update moves every such element by lr or 2 lr. Returns
    the largest gradient difference (of its leaf's largest), the largest
    such update difference, the largest share of them beyond the
    tolerance in one leaf, and the share of all elements left to the
    bound, with the leaf that leaves most."""
    grad_gap, worst, beyond, loose, total = 0.0, 0.0, 0.0, 0, 0
    loosest = ("", 0.0)
    for name, m in want_m.items():
        scale = float(np.abs(m).max())
        gap = float(np.abs(got_m[name] - m).max()) / scale if scale else 0.0
        require(gap <= PAR_GRAD_TOL, f"{what}: {name}'s gradient differs by {gap:.3g} of its "
                                     f"largest")
        diff = np.abs((got[name] - before[name]) - (want[name] - before[name]))
        require(float(diff.max()) <= 2.02 * lr,
                f"{what}: {name}'s update differs by {diff.max()}, beyond Adam's bound 2 lr")
        clear = ((np.abs(m) > PAR_ZERO * scale) | (m == 0)) & ~_zero_by_construction(name,
                                                                                     m.shape)
        kept = diff[clear]
        if kept.size:
            n_beyond = int((kept > PAR_UPDATE_TOL * lr).sum())
            share = n_beyond / kept.size
            require(n_beyond <= max(PAR_FLIP_SHARE * kept.size, PAR_FLIP_FLOOR),
                    f"{what}: {name}'s update differs beyond {PAR_UPDATE_TOL} lr on "
                    f"{share:.2%} of its elements (largest {kept.max()})")
            worst, beyond = max(worst, float(kept.max())), max(beyond, share)
        grad_gap = max(grad_gap, gap)
        loose += int((~clear).sum())
        total += m.size
        loosest = max(loosest, (name, float((~clear).mean())), key=lambda t: t[1])
    return {"grad_gap": grad_gap, "max_abs_diff": worst, "beyond_share": beyond,
            "loose_share": loose / total, "loosest_leaf": loosest}


def _update_line(vs_one: dict, vs_cpu: dict, lr: float, one: str = "one lane") -> str:
    return (f"the first step vs {one} and vs CPU: gradients within {vs_one['grad_gap']:.2g} and "
            f"{vs_cpu['grad_gap']:.2g} of a leaf's largest (tolerance {PAR_GRAD_TOL}); updates "
            f"within {vs_one['max_abs_diff']:.3g} and {vs_cpu['max_abs_diff']:.3g} (lr {lr:g}), "
            f"beyond {PAR_UPDATE_TOL} lr on at most {vs_one['beyond_share']:.2g} and "
            f"{vs_cpu['beyond_share']:.2g} of a leaf (tolerance {PAR_FLIP_SHARE}), "
            f"{vs_one['loose_share']:.2g} and {vs_cpu['loose_share']:.2g} of the weights left to "
            f"Adam's bound")


def _losses_agree(got: list[float], want: list[float], what: str) -> float:
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    require(gap <= PAR_LOSS_TOL, f"{what}: losses {got} against {want}")
    return gap


def parallel_phase(seed: int, batch: int, prod: dict) -> dict:
    """Phase 5n (ROADMAP 13), on lanes of cuda:0 (a check of the lane
    algebra, not a deployment), each comparison repeated on CPU lanes in
    this call: (1) `make_ep_moe` over 2 and 4 lanes against the one-lane
    MoE routed with each shard's capacity; (2) `make_ep_train_step(attn=
    "flash")` over 2 and 4 lanes against the one-lane step with per-shard
    capacity, the MoE model's `seq_score`, and the memory allocated after
    steps 3 and 8; (3) `make_sp_train_step` (ring, ulysses) over 4 lanes
    against `seq_train_step`; (4) `ring_attention` at [16, 4096, 4, 32]
    against `blockwise_attention`; (5) the pipeline's forward and train
    step over 4 stages against the sequential blocks; (6)
    `cluster_sketch_step(use_tp=True)` on a 2 x 2 mesh against the DP
    step. Returns the K1 and K3 launches of the card's runs."""
    from inspektor_gadget_tpu_torch.models import autoencoder as AE
    from inspektor_gadget_tpu_torch.models import params_to_numpy
    from inspektor_gadget_tpu_torch.models import seqmodel as SM
    from inspektor_gadget_tpu_torch.ops import bundle_to_numpy
    from inspektor_gadget_tpu_torch.parallel import cluster as C
    from inspektor_gadget_tpu_torch.parallel import mesh as MESH
    from inspektor_gadget_tpu_torch.parallel import moe as MOE
    from inspektor_gadget_tpu_torch.parallel import pipeline as PPL
    from inspektor_gadget_tpu_torch.parallel import ring_attention as RA
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    rng = np.random.default_rng(seed)
    out: dict = {"launches": {"K1": 0, "K2": 0, "K3": 0}}
    t_phase = time.perf_counter()

    def counted(fn):
        """`fn()` on the card with the launch counts set to 0 just before
        and read just after: (its result, its seconds ending in a
        synchronize, its launches), the launches added to the phase's."""
        reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read_launches()
        for k, v in launched.items():
            out["launches"][k] += v
        return res, secs, launched

    # (1) make_ep_moe over 2 and 4 lanes against the one-lane MoE with
    # each shard's capacity, and against the same on CPU lanes
    moe = MOE.moe_init(seed, 8, 128, 256)
    x = torch.from_numpy(rng.normal(size=(PAR_TOKENS, 128)).astype(np.float32))
    with torch.no_grad():
        for n in (2, 4):
            shard = PAR_TOKENS // n
            cap = max(1, int(shard / 8 * 2.0))
            res = {}
            for where, d in (("card", dev), ("cpu", cpu)):
                m, xx = copy.deepcopy(moe).to(d), x.to(d)
                fn = MOE.make_ep_moe([d] * n, 8)
                fn(m, xx)  # warm: the timed call below is the second
                if where == "card":
                    (y, (bal, drop)), secs, _ = counted(lambda: fn(m, xx))
                else:
                    t0 = time.perf_counter()
                    y, (bal, drop) = fn(m, xx)
                    secs = time.perf_counter() - t0
                one = torch.cat([MOE.moe_apply(m, xx[i * shard:(i + 1) * shard])[0]
                                 for i in range(n)])
                err = float((y - one).abs().max())
                require(torch.allclose(y, one, rtol=PAR_TOL, atol=PAR_TOL),
                        f"EP MoE ({where}, {n} lanes) against one lane: max abs diff {err}")
                routes = [MOE._route(xx[i * shard:(i + 1) * shard], m.gate, cap)
                          for i in range(n)]
                res[where] = (y.detach().cpu(), routes, float(bal), float(drop), err, secs)
            (yc, rc_, balc, dropc, errc, secc), (yp, rp, balp, dropp, errp, secp) = \
                res["card"], res["cpu"]
            ec = torch.cat([r.expert for r in rc_]).cpu()
            kc = torch.cat([r.keep for r in rc_]).cpu()
            ep = torch.cat([r.expert for r in rp])
            kp = torch.cat([r.keep for r in rp])
            same = (ec == ep) & (kc == kp)
            moved = int((~same).sum())
            require(moved <= PAR_TOKENS // 1000,
                    f"EP MoE {n} lanes: {moved} tokens routed otherwise on the card than the CPU")
            vs_cpu = float((yc - yp)[same].abs().max())
            require(torch.allclose(yc[same], yp[same], rtol=PAR_TOL, atol=PAR_TOL),
                    f"EP MoE {n} lanes, card vs CPU: max abs diff {vs_cpu}")
            out[f"ep_moe_{n}"] = {"vs_one_lane": errc, "cpu_vs_one_lane": errp,
                                  "vs_cpu": vs_cpu,
                                  "routing_moved": moved, "balance": balc, "dropped": dropc,
                                  "ms": secc * 1e3, "cpu_ms": secp * 1e3}
            log(f"[parallel] (5n) make_ep_moe over {n} lanes, {PAR_TOKENS} tokens, d 128, 8 "
                f"experts of d_ff 256: {secc * 1e3:.2f} ms on the card ({secp * 1e3:.1f} on the "
                f"CPU); "
                f"against one lane with per-shard capacity {cap}: max abs diff {errc:.3g} (CPU "
                f"{errp:.3g}); card vs CPU {vs_cpu:.3g} (tolerance {PAR_TOL}); routing (expert, "
                f"kept) differs on {moved} of {PAR_TOKENS} tokens; balance {balc:.4f}, dropped "
                f"{dropc:.4f} (each time the second call)")

    # (2) make_ep_train_step(attn="flash") over 2 and 4 lanes at the seq
    # defaults with 8 experts, window 256
    cfg = SM.SeqConfig(n_experts=8)
    toks = (rng.zipf(1.3, (PAR_ROWS, SEQ_WINDOW)) % cfg.vocab).astype(np.int64)
    toks[-1, SEQ_WINDOW // 2:] = -1
    for n in (2, 4):
        card = SM.seq_init(cfg, seed=seed, device=dev)
        w0 = _flat(params_to_numpy(card))
        step = SM.make_ep_train_step([dev] * n, cfg, card, attn="flash")
        steps = PAR_STEPS
        step_s: list[float] = []

        def timed_steps(k: int) -> list[float]:
            out_l = []
            for _ in range(k):
                t_s = time.perf_counter()
                out_l.append(float(step(toks)))  # .item() waits for the step
                step_s.append(time.perf_counter() - t_s)
            return out_l

        # one lane: the same model, each row shard routed with its own capacity
        one = SM.seq_init(cfg, seed=seed, device=dev)
        cpu_sc = SM.seq_init(cfg, seed=seed, device="cpu")
        cpu_step = SM.make_ep_train_step([cpu] * n, cfg, cpu_sc, attn="flash")
        t_toks = torch.from_numpy(toks).to(dev)

        def one_lane_step() -> float:
            one.opt.zero_grad(set_to_none=True)
            terms = [SM._next_token_terms(one.model, part, cfg, "flash")
                     for part in t_toks.chunk(n)]
            loss = (sum(s.sum() for s, _, _ in terms) / sum(c.sum() for _, c, _ in terms)
                    + cfg.balance_coef * torch.stack([b for _, _, b in terms]).mean())
            loss.backward()
            one.opt.step()
            return float(loss.detach())

        losses, one_losses, cpu_losses = [], [], []
        secs, launched = 0.0, {"K1": 0, "K2": 0, "K3": 0}
        for i in range(steps):
            got, secs_i, launched_i = counted(lambda: timed_steps(1))
            losses += got
            secs += secs_i
            launched = {k: launched[k] + launched_i[k] for k in launched}
            one_losses.append(one_lane_step())
            cpu_losses.append(float(cpu_step(toks)))
            if i == 0:  # the first update, from the same weights
                after = _flat(params_to_numpy(card))
                m_card = _first_moment(card)
                u_one = _update_agrees(w0, after, _flat(params_to_numpy(one)), m_card,
                                       _first_moment(one), cfg.lr, f"EP step {n} lanes vs one lane")
                u_cpu = _update_agrees(w0, after, _flat(params_to_numpy(cpu_sc)), m_card,
                                       _first_moment(cpu_sc), cfg.lr, f"EP step {n} lanes vs CPU")
        want_k3 = steps * n * cfg.n_layers  # each lane's forward, a layer (the backward recomputes)
        require(launched["K3"] == want_k3 and launched["K2"] == 0,
                f"EP step {n} lanes launched {launched}, expected K3 {want_k3}")
        gap_one = _losses_agree(losses, one_losses, f"EP step {n} lanes vs one lane")
        gap_cpu = _losses_agree(losses, cpu_losses, f"EP step {n} lanes vs CPU")
        scores, _, launched = counted(lambda: SM.seq_score(card, toks, "flash"))
        require(launched["K3"] == cfg.n_layers, f"MoE seq_score launched {launched}")
        cpu_scores = SM.seq_score(cpu_sc, toks, "flash")
        s_gap = float((scores.cpu() - cpu_scores).abs().max())
        require(s_gap <= 0.05, f"MoE seq scores, card vs CPU: max abs diff {s_gap}")
        entry = {"losses": losses, "one_lane_losses": one_losses, "cpu_losses": cpu_losses,
                 "loss_gap_vs_one_lane": gap_one, "loss_gap_vs_cpu": gap_cpu,
                 "update_vs_one_lane": u_one, "update_vs_cpu": u_cpu,
                 "step_ms": secs / steps * 1e3,
                 "scores_vs_cpu": s_gap, "k3_step_launches": want_k3}
        if n == 4:  # lane copies must not outlive their step: memory after steps 3 and 8
            mem = {steps: torch.cuda.memory_allocated(dev)}
            more, _, _ = counted(lambda: timed_steps(PAR_MEMORY_STEPS - steps))
            mem[PAR_MEMORY_STEPS] = torch.cuda.memory_allocated(dev)
            growth = mem[PAR_MEMORY_STEPS] - mem[steps]
            require(growth <= 1 << 20 and all(np.isfinite(more)),
                    f"EP step: memory grew {growth} bytes from step {steps} to "
                    f"{PAR_MEMORY_STEPS}: {mem}")
            entry.update(memory_growth_bytes=growth, memory_allocated=mem, later_losses=more)
        entry["warm_step_ms"] = statistics.median(step_s[1:]) * 1e3
        out[f"ep_train_{n}"] = entry
        log(f"[parallel] (5n) make_ep_train_step(attn='flash') over {n} lanes, {PAR_ROWS} x "
            f"{SEQ_WINDOW} tokens, seq defaults with 8 experts: {steps} steps, "
            f"{secs / steps * 1e3:.1f} ms a step (median after the first "
            f"{entry['warm_step_ms']:.1f} over {len(step_s) - 1}), losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; "
            f"one lane {one_losses[-1]:.4f}, CPU {cpu_losses[-1]:.4f} (every step within "
            f"{gap_one:.2g} and {gap_cpu:.2g} relative, tolerance {PAR_LOSS_TOL}); "
            f"{_update_line(u_one, u_cpu, cfg.lr)}; K3 {want_k3} in the steps (by count); MoE "
            f"seq_score card vs CPU {s_gap:.3g} nats (tolerance 0.05)"
            + (f"; memory {entry['memory_growth_bytes']} bytes grown from step {steps} to "
               f"{PAR_MEMORY_STEPS}" if n == 4 else ""))
        del card, step, one, cpu_sc, cpu_step

    # (3) make_sp_train_step, ring and Ulysses over 4 lanes, at the seq
    # defaults (dense) against the one-lane step
    dense = SM.SeqConfig()
    for attn in ("ring", "ulysses"):
        card = SM.seq_init(dense, seed=seed, device=dev)
        w0 = _flat(params_to_numpy(card))
        step = SM.make_sp_train_step([dev] * 4, dense, card, attn=attn)
        one = SM.seq_init(dense, seed=seed, device=dev)
        cpu_sc = SM.seq_init(dense, seed=seed, device="cpu")
        cpu_step = SM.make_sp_train_step([cpu] * 4, dense, cpu_sc, attn=attn)
        losses, one_losses, cpu_losses, secs = [], [], [], 0.0
        for i in range(PAR_STEPS):
            got, secs_i, _ = counted(lambda: float(step(toks)))
            losses.append(got)
            secs += secs_i
            one_losses.append(float(SM.seq_train_step(one, toks, "full")[1]))
            cpu_losses.append(float(cpu_step(toks)))
            if i == 0:  # the first update, from the same weights
                after = _flat(params_to_numpy(card))
                m_card = _first_moment(card)
                u_one = _update_agrees(w0, after, _flat(params_to_numpy(one)), m_card,
                                       _first_moment(one), dense.lr, f"SP {attn} vs one lane")
                u_cpu = _update_agrees(w0, after, _flat(params_to_numpy(cpu_sc)), m_card,
                                       _first_moment(cpu_sc), dense.lr, f"SP {attn} vs CPU")
        gap_one = _losses_agree(losses, one_losses, f"SP {attn} vs one lane")
        gap_cpu = _losses_agree(losses, cpu_losses, f"SP {attn} vs CPU")
        out[f"sp_{attn}"] = {"losses": losses, "one_lane_losses": one_losses,
                             "cpu_losses": cpu_losses, "loss_gap_vs_one_lane": gap_one,
                             "loss_gap_vs_cpu": gap_cpu, "update_vs_one_lane": u_one,
                             "update_vs_cpu": u_cpu, "step_ms": secs / PAR_STEPS * 1e3}
        log(f"[parallel] (5n) make_sp_train_step({attn!r}) over 4 lanes, {PAR_ROWS} x "
            f"{SEQ_WINDOW} tokens, seq defaults: {secs / PAR_STEPS * 1e3:.1f} ms a step, losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; one lane (attn 'full') "
            f"{one_losses[-1]:.4f}, CPU {cpu_losses[-1]:.4f} (every step within {gap_one:.2g} "
            f"and {gap_cpu:.2g} relative, tolerance {PAR_LOSS_TOL}); "
            f"{_update_line(u_one, u_cpu, dense.lr)}")
        del card, step, one, cpu_sc, cpu_step

    # (4) ring attention at [16, 4096, 4, 32] over 4 lanes against blockwise
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(PAR_RING, generator=gen) for _ in range(3))
    ring = RA.make_ring_attention([dev] * 4, causal=True)
    qc, kc, vc = q.to(dev), k.to(dev), v.to(dev)
    ring(qc, kc, vc)  # warm: the timed call below is the second
    got, secs, _ = counted(lambda: ring(qc, kc, vc))
    want = RA.blockwise_attention(qc, kc, vc, causal=True, chunk=128)
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
            f"ring attention {PAR_RING} vs blockwise on the card: max abs diff {err}")
    b = PAR_RING_CPU_B
    cpu_ring = RA.make_ring_attention([cpu] * 4, causal=True)(q[:b], k[:b], v[:b])
    cpu_err = float((cpu_ring - RA.blockwise_attention(q[:b], k[:b], v[:b], chunk=128)).abs().max())
    vs_cpu = float((got[:b].cpu() - cpu_ring).abs().max())
    require(cpu_err <= 2e-5 and vs_cpu <= 2e-5,
            f"ring attention on the CPU: vs blockwise {cpu_err}, card vs CPU {vs_cpu}")
    out["ring_attention"] = {"shape": PAR_RING, "vs_blockwise": err, "cpu_vs_blockwise": cpu_err,
                             "vs_cpu": vs_cpu, "ms": secs * 1e3}
    log(f"[parallel] (5n) ring_attention {PAR_RING} f32 causal over 4 lanes: {secs * 1e3:.1f} ms "
        f"(host clock, the second call); vs blockwise_attention max abs diff {err:.3g}, on the CPU "
        f"(4 of the 16 rows) {cpu_err:.3g}, card vs CPU {vs_cpu:.3g} (tolerance 2e-5)")
    del q, k, v, qc, kc, vc, got, want

    # (5) the pipeline over 4 stages, forward and train step
    stages, micro, mb = PAR_PP
    params = PPL.pp_block_init(seed, stages, 128, 256)
    x = torch.from_numpy(rng.normal(size=(micro, mb, 128)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(micro, mb, 8)).astype(np.float32))
    head = torch.from_numpy((rng.normal(size=(128, 8)) * 0.1).astype(np.float32))
    pc = {kk: vv.to(dev) for kk, vv in params.items()}
    PPL.make_pp_forward([dev] * stages)(pc, x.to(dev))  # warm
    fwd, secs, _ = counted(lambda: PPL.make_pp_forward([dev] * stages)(pc, x.to(dev)))
    seq = torch.stack([PPL.pp_reference(pc, x[i].to(dev)) for i in range(micro)])
    scale = float(seq.abs().max())
    err = float((fwd - seq).abs().max())
    require(err <= 1e-5 * scale, f"pipeline forward vs pp_reference on the card: {err}")
    cpu_fwd = PPL.make_pp_forward([cpu] * stages)(params, x)
    vs_cpu = float((fwd.cpu() - cpu_fwd).abs().max())
    require(vs_cpu <= PAR_TOL * scale, f"pipeline forward, card vs CPU: {vs_cpu} of {scale}")

    def sgd_reference(p, h, lr=1e-2):
        leaves = {kk: vv.detach().requires_grad_() for kk, vv in p.items()}
        hh = h.detach().requires_grad_()
        out_ = torch.stack([PPL.pp_reference(leaves, x[i].to(hh.device)) for i in range(micro)])
        loss = torch.mean((out_ @ hh - y.to(hh.device)) ** 2)
        grads = torch.autograd.grad(loss, [*leaves.values(), hh])
        with torch.no_grad():
            return ({kk: vv - lr * g for (kk, vv), g in zip(leaves.items(), grads)},
                    hh - lr * grads[-1], float(loss.detach()))

    pstep = PPL.make_pp_train_step([dev] * stages, lr=1e-2)
    cpu_pstep = PPL.make_pp_train_step([cpu] * stages, lr=1e-2)
    p, h, rp, rh, cp_, ch = pc, head.to(dev), pc, head.to(dev), params, head
    pp_losses, ref_losses, cpu_losses, t_train = [], [], [], 0.0
    for _ in range(PAR_STEPS):
        (p, h, loss), secs_s, _ = counted(lambda: pstep(p, h, x.to(dev), y.to(dev)))
        t_train += secs_s
        rp, rh, rloss = sgd_reference(rp, rh)
        cp_, ch, closs = cpu_pstep(cp_, ch, x, y)
        pp_losses.append(float(loss))
        ref_losses.append(rloss)
        cpu_losses.append(float(closs))
    w_ref = max(float((p[kk] - rp[kk]).abs().max()) for kk in p)
    w_cpu = max(float((p[kk].cpu() - cp_[kk]).abs().max() / cp_[kk].abs().max()) for kk in p)
    require(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(pp_losses, ref_losses))
            and w_ref <= 1e-5 * max(float(rp[kk].abs().max()) for kk in rp),
            f"pipeline train step vs the sequential SGD on the card: losses {pp_losses} "
            f"{ref_losses}, weights {w_ref}")
    require(all(abs(a - b) <= PAR_TOL * abs(b) for a, b in zip(pp_losses, cpu_losses))
            and w_cpu <= PAR_TOL, f"pipeline train step card vs CPU: {pp_losses} {cpu_losses}")
    out["pipeline"] = {"forward_vs_reference": err, "forward_vs_cpu": vs_cpu, "scale": scale,
                       "forward_ms": secs * 1e3, "losses": pp_losses, "cpu_losses": cpu_losses,
                       "weights_vs_reference": w_ref, "weights_vs_cpu_rel": w_cpu,
                       "step_ms": t_train / PAR_STEPS * 1e3}
    log(f"[parallel] (5n) make_pp_forward over {stages} stages, {micro} microbatches of {mb} x "
        f"128: {secs * 1e3:.2f} ms; vs pp_reference max abs diff {err:.3g} (tolerance 1e-5 of "
        f"{scale:.3g}), card vs CPU {vs_cpu:.3g} (tolerance {PAR_TOL} of it); train step "
        f"{t_train / PAR_STEPS * 1e3:.2f} ms, losses {pp_losses[0]:.5f} -> {pp_losses[-1]:.5f} "
        f"(sequential SGD {ref_losses[-1]:.5f}, CPU {cpu_losses[-1]:.5f}); weights vs the "
        f"sequential SGD {w_ref:.3g}, vs CPU {w_cpu:.3g} relative")

    # (6) cluster_sketch_step(use_tp=True) on a 2 x 2 mesh against the DP step
    ae_cfg = AE.AEConfig()
    keys = rng.zipf(1.2, (PAR_STEPS, 2, batch)).clip(1, 2**32 - 1).astype(np.uint32)
    counts = rng.poisson(2.0, (PAR_STEPS, 2, PAR_AE_ROWS, ae_cfg.input_dim)).astype(np.float32)
    runs = {}
    for name, where, n_model in (("tp", dev, 2), ("dp", dev, 1), ("tp_cpu", cpu, 2)):
        mesh = MESH.make_mesh(n_nodes=2, n_model=n_model, devices=[where] * (2 * n_model))
        state = C.cluster_init(mesh, AE.ae_init(ae_cfg, seed=seed, device=where), **prod)
        stepf, merge = C.make_cluster_step(mesh, state)
        losses, secs_all = [], 0.0

        def weights():
            return _flat(AE.ae_gather_tp(state.scorer) if n_model > 1
                         else params_to_numpy(state.scorer))

        runs[name] = {"w0": weights()}
        for s_ in range(PAR_STEPS):
            ks = [torch.from_numpy(r.view(np.int32).copy()).to(where) for r in keys[s_]]
            mask = [torch.ones(batch, dtype=torch.bool, device=where)] * 2
            cs = [torch.from_numpy(c).to(where) for c in counts[s_]]
            if name == "tp":
                (state, loss), secs_s, launched = counted(
                    lambda: stepf(state, ks, ks, ks, mask, cs))
                require(launched == {"K1": 2, "K2": 0, "K3": 0},
                        f"TP cluster step launched {launched}: K1 once a node lane")
                secs_all += secs_s
            else:
                state, loss = stepf(state, ks, ks, ks, mask, cs)
            losses.append(float(loss))
            if s_ == 0:  # the first update, and the replicated step's gradient
                runs[name]["first"] = weights()
                runs[name]["moment"] = _first_moment(state.scorer)
        runs[name].update(lanes=[bundle_to_numpy(b) for b in state.lanes],
                          merged=bundle_to_numpy(merge(state.lanes)),
                          losses=losses, ms=secs_all / PAR_STEPS * 1e3)
    for other in ("dp", "tp_cpu"):
        for i, (a, b_) in enumerate(zip(runs["tp"]["merged"], runs[other]["merged"])):
            require(a.dtype == b_.dtype and np.array_equal(a, b_),
                    f"TP cluster step: merged leaf {i} differs from the {other} run's")
        for lane, (la, lb) in enumerate(zip(runs["tp"]["lanes"], runs[other]["lanes"])):
            require(all(np.array_equal(a, b_) for a, b_ in zip(la, lb)),
                    f"TP cluster step: lane {lane}'s bundle differs from the {other} run's")
        require(all(np.array_equal(runs["tp"]["w0"][kk], runs[other]["w0"][kk])
                    for kk in runs["tp"]["w0"]), f"TP cluster step: {other} starts elsewhere")
        runs[other]["loss_gap"] = _losses_agree(runs["tp"]["losses"], runs[other]["losses"],
                                                f"TP cluster step vs {other}")
        runs[other]["update"] = _update_agrees(runs["tp"]["w0"], runs["tp"]["first"],
                                               runs[other]["first"], runs["tp"]["moment"],
                                               runs[other]["moment"], ae_cfg.learning_rate,
                                               f"TP cluster step vs {other}")
    out["cluster_tp"] = {"losses": runs["tp"]["losses"], "dp_losses": runs["dp"]["losses"],
                         "cpu_losses": runs["tp_cpu"]["losses"], "step_ms": runs["tp"]["ms"],
                         "loss_gap_vs_dp": runs["dp"]["loss_gap"],
                         "loss_gap_vs_cpu": runs["tp_cpu"]["loss_gap"],
                         "update_vs_dp": runs["dp"]["update"],
                         "update_vs_cpu": runs["tp_cpu"]["update"]}
    tp_update = _update_line(runs["dp"]["update"], runs["tp_cpu"]["update"],
                             ae_cfg.learning_rate, "the replicated DP scorer")
    log(f"[parallel] (5n) cluster_sketch_step(use_tp=True) on a 2 x 2 mesh of cuda:0, "
        f"{batch}-event batches at the production geometry, AE 4096 -> 512 -> 128 bf16 on "
        f"{PAR_AE_ROWS} rows a node: {runs['tp']['ms']:.1f} ms a step; every bundle leaf and "
        f"the merge equal the DP step's and the CPU's; losses {runs['tp']['losses'][0]:.3g} -> "
        f"{runs['tp']['losses'][-1]:.3g} (DP {runs['dp']['losses'][-1]:.3g}, CPU "
        f"{runs['tp_cpu']['losses'][-1]:.3g}; every step within {runs['dp']['loss_gap']:.2g} "
        f"and {runs['tp_cpu']['loss_gap']:.2g} relative, tolerance {PAR_LOSS_TOL}); "
        f"{tp_update}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[parallel] phase 5n took {out['seconds']:.1f} s; launches on the card's runs "
        f"{out['launches']}")
    return out


PERF_CONFIG = "e2e-prod"     # the harness config of 5o(a): bench.py's production geometry
PERF_SECONDS = 1.5           # 5o(a)'s windows: the config's is 3 s
PERF_CLI_CONFIG = "e2e"      # 5o(c)'s subprocess
PERF_FANOUT_MESSAGES = 5000  # 5o(b)'s fan-out: the reference's default is 20000
PERF_JOURNAL = "chip_smoke_perf_journal"  # 5f(a)'s recording, kept for 5o(a)'s replay


def _quiet(fn, *args, **kw):
    """fn's return value and what it printed (a CLI verb in process)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kw)
    return rc, buf.getvalue()


def perf_phase(device: str, rep: dict, root: Path, journal: str,
               config: str = PERF_CONFIG) -> dict:
    """Phase 5o (ROADMAP 20): the harness's arms at `config` on `device`,
    the seven bench modules' `publish` on `device` with their
    deterministic outputs held to a CPU call's, and the `bench` CLI. Every
    record goes to one ledger under `root`. Returns the runs, the bench
    records' values, the CLI's process time and the K1 and K2 launches.
    Runs on the CPU too (`device="cpu"`, a small `config`), where no
    kernel launches."""
    from inspektor_gadget_tpu_torch.capture import ReplaySource
    from inspektor_gadget_tpu_torch.cli.bench import main as bench_main
    from inspektor_gadget_tpu_torch.ops.quantiles import dd_merge, dd_quantile
    from inspektor_gadget_tpu_torch.perf import (accuracy_bench, fanout, fleet_bench,
                                                 history_bench, invertible_bench,
                                                 quantile_bench, standing_bench)
    from inspektor_gadget_tpu_torch.perf import harness as PH
    from inspektor_gadget_tpu_torch.perf.compare import compare_ledger, render_compare
    from inspektor_gadget_tpu_torch.perf.compare import render_report
    from inspektor_gadget_tpu_torch.perf.ledger import append_record, read_ledger
    from inspektor_gadget_tpu_torch.perf.schema import HOST_STAGES, validate_record

    t_phase = time.perf_counter()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    on_card = dev.type == "cuda"
    platform = "gpu" if on_card else "cpu"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ledger, cpu_ledger = str(root / "PERF.jsonl"), str(root / "PERF-cpu.jsonl")
    card = rep["kind"]
    out: dict = {"runs": {}, "benches": {}, "launches": {"K1": 0, "K2": 0}}
    log(f"[perf] (5o) {rep['nvidia_smi']}; ledger {ledger}")

    def held(rec: dict, what: str, on: str = platform) -> None:
        prov = rec["provenance"]
        require(validate_record(rec) == [], f"{what}: invalid record {validate_record(rec)}")
        require(prov["platform"] == on and prov["degraded"] is False,
                f"{what}: platform {prov['platform']}, degraded {prov['degraded']}")
        require(on != "gpu" or card in prov["probe"].get("detail", ""),
                f"{what}: the probe trail does not name {card}: {prov['probe']}")

    # (a) the harness's arms in this process
    counts = [b.count for b in ReplaySource(journal).batches]
    arms = {"fused": {}, "fused +inv +qt": dict(invertible=True, quantiles=True),
            "classic": dict(pipeline="classic"),
            "sharded x2": dict(pipeline="sharded", chips=2, lanes=[dev, dev]),
            "fused --replay 5f(a)": dict(replay=journal)}
    for name, kw in arms.items():
        reset_launches()
        t0 = time.perf_counter()
        rec = PH.run_harness(config, device=device, seconds=PERF_SECONDS, **kw)
        wall = time.perf_counter() - t0
        launched = read_launches()
        append_record(rec, ledger)
        held(rec, f"harness {name}")
        ex = rec["extra"]
        steps, pipeline = ex["steps"], kw.get("pipeline", "fused")
        want = (sum(counts[i % len(counts)] for i in range(steps)) if "replay" in kw
                else steps * ex["batch"] - ex.get("drops", 0))
        require(ex["events"] == want, f"harness {name}: events {ex['events']}, expected {want}")
        update = {"fused": "fused_update", "classic": "bundle_update",
                  "sharded": "sharded_update"}[pipeline]
        arm_stages = (*HOST_STAGES[pipeline], update, "harvest")
        require(all(s in rec["stages"] for s in arm_stages)
                and all(st["seconds"] > 0 for st in rec["stages"].values()),
                f"harness {name}: stages {rec['stages']}")
        if not on_card:
            expect = {"K1": 0, "K2": 0, "K3": 0}
        elif pipeline == "fused":
            expect = {"K1": 0, "K2": PH.WARM_STEPS + steps, "K3": 0}
        elif pipeline == "classic":
            expect = {"K1": PH.WARM_STEPS + steps, "K2": 0, "K3": 0}
        else:  # the harness checked each of its loops: K2 once a lane a step
            expect = {"K1": 0, "K2": launched["K2"], "K3": 0}
            require(launched["K2"] > ex["chips"] * (steps + 1),
                    f"harness {name}: K2 {launched['K2']} over {steps} rounds")
        require(launched == expect, f"harness {name}: launched {launched}, expected {expect}")
        out["launches"]["K1"] += launched["K1"]
        out["launches"]["K2"] += launched["K2"]
        out["runs"][name] = {"value": rec["value"], "unit": rec["unit"], "steps": steps,
                             "events": ex["events"], "wall_s": wall, "launches": launched,
                             "stages": rec["stages"],
                             **{k: ex[k] for k in ("host_plane_ev_per_s", "starved_fraction",
                                                   "per_chip_ev_per_s",
                                                   "device_plane_wall_ev_per_s",
                                                   "e2e_wall_ev_per_s") if k in ex}}
        log(f"[perf] (5o a) {name}: {rec['value']:.1f} {rec['unit']} over {steps} steps of "
            f"{ex['batch']} ({ex['events']} events, {wall:.1f} s with warm-up and post-loop "
            f"stages); launches {launched}; " + ", ".join(
                f"{k} {ex[k]:.1f}" for k in ("host_plane_ev_per_s", "per_chip_ev_per_s",
                                             "device_plane_wall_ev_per_s", "e2e_wall_ev_per_s")
                if k in ex))
        log(f"[perf] (5o a) {name} stages (s): " + ", ".join(
            f"{s} {st['seconds']:.4f}" for s, st in rec["stages"].items()))

    # (b) the seven bench modules on the card, then each deterministic
    # output held to a CPU call's; (c)'s CLI run beside them
    def publish(name: str, mod, **kw) -> list[dict]:
        reset_launches()
        t0 = time.perf_counter()
        recs = mod.publish(device=device, ledger=ledger, **kw)
        wall = time.perf_counter() - t0
        launched = read_launches()
        for r in recs:
            held(r, f"{name} {r['config']}")
        out["launches"]["K1"] += launched["K1"]
        out["launches"]["K2"] += launched["K2"]
        out["benches"][name] = {"wall_s": wall, "launches": launched,
                                "records": {r["config"]: r["value"] for r in recs}}
        log(f"[perf] (5o b) {name} ({wall:.1f} s, launches {launched}): " + "; ".join(
            f"{r['config']} {r['value']:.6g} {r['unit']}" for r in recs))
        return recs

    host_benches = (  # host work: the CPU's records must carry the same counts
        ("standing_bench", standing_bench, {},
         ("range_small", "range_large", "range_windows", "folds_during_reads")),
        ("history_bench", history_bench, {},
         ("windows", "super_windows", "bytes_reclaimed", "pushdown_wire_bytes",
          "fetch_wire_bytes", "wire_ratio")),
        ("fleet_bench", fleet_bench, {},
         ("agents", "fan_in", "depth", "digest", "wire_windows", "client_link_windows",
          "client_link_bytes")),
        ("fanout", fanout, {"messages": PERF_FANOUT_MESSAGES},
         ("subscribers", "delivered", "drops")))
    # (c) the CLI: one `bench run` as a user runs it, in a process of its
    # own. It imports torch beside (b)'s benches (a core of the host's 8)
    # and runs its window beside (b)'s CPU calls (checks, not
    # measurements): its own rate is logged, not a measurement
    cli_box: dict = {}
    cli = threading.Thread(target=lambda: cli_box.update(run_at_once({"bench run": [
        sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main", "bench", "run",
        "--config", PERF_CLI_CONFIG, "--device", device, "--ledger", ledger, "-o", "summary"]},
        timeout=300)), daemon=True)
    cli.start()
    publish("quantile_bench", quantile_bench)
    acc_recs = publish("accuracy_bench", accuracy_bench)
    acc = out["benches"]["accuracy_bench"]["launches"]
    require(acc["K2"] == 0 and (acc["K1"] > 0) == on_card,
            f"accuracy_bench: launched {acc}; bundle_update runs K1 on the card")
    publish("invertible_bench", invertible_bench)
    host_recs = {name: publish(name, mod, **kw) for name, mod, kw, _keys in host_benches}

    merged = [dd_merge(*quantile_bench.merged_sketch(device=d)) for d in (dev, "cpu")]
    require(all(torch.equal(getattr(merged[0], f).cpu(), getattr(merged[1], f))
                for f in ("counts", "zeros", "total")), "quantile_bench: merged sketch differs")
    qs = [0.5, 0.9, 0.99, 0.999]
    qv = [dd_quantile(m, qs).cpu().numpy() for m in merged]
    q_rel = float(np.max(np.abs(qv[0] - qv[1]) / np.abs(qv[1])))
    require(q_rel <= 1e-6, f"quantile_bench: merged quantiles {qv[0]} vs CPU {qv[1]}")
    log(f"[perf] (5o b) quantile_bench: the merged sketch equals the CPU's; quantiles "
        f"{dict(zip(qs, qv[0].tolist()))}, {q_rel:.3g} from the CPU's")
    cpu_err = accuracy_bench.measure_observed_err(device="cpu")
    err = acc_recs[2]["extra"]
    want = {k: round(cpu_err[k], 5) for k in ("observed_err_pct", "max_err_pct", "bound_pct")}
    require({k: err[k] for k in want} == want and err["audited_keys"] == cpu_err["audited_keys"],
            f"accuracy_bench: observed error {err} vs the CPU's {cpu_err}")
    log(f"[perf] (5o b) accuracy_bench: observed error {err['observed_err_pct']}% (max "
        f"{err['max_err_pct']}%, bound {err['bound_pct']}%) over {err['audited_keys']} keys, "
        f"the CPU's")
    decoded = [invertible_bench.measure_decode(reps=1, device=d)["decoded"] for d in (dev, "cpu")]
    require(decoded[0] == decoded[1], "invertible_bench: the decoded keys differ from the CPU's")
    log(f"[perf] (5o b) invertible_bench: {len(decoded[0])} keys decoded, complete, the CPU's")
    for name, mod, kw, keys in host_benches:
        recs = host_recs[name]
        cpu_recs = mod.publish(device="cpu", ledger=cpu_ledger, **kw)
        for g, w in zip(recs, cpu_recs, strict=True):
            held(w, f"{w['config']} on the CPU", "cpu")
            gx, wx = ({k: r["extra"][k] for k in keys if k in r["extra"]} for r in (g, w))
            require(gx == wx and gx, f"{name} {g['config']}: card {gx} vs CPU {wx}")
        log(f"[perf] (5o b) {name}: " + "; ".join(
            f"{r['config']} " + ", ".join(f"{k} {r['extra'][k]}" for k in keys
                                          if k in r["extra"] and k != "digest")
            for r in recs) + ", the CPU's")
    host = [r for recs in host_recs.values() for r in recs]
    require(all(r["extra"]["folds_during_reads"] == 0 for r in host
                if r["config"] == "standing-cache-hit"), "standing_bench: a cache read folded")
    require(all(r["extra"]["delivered"] == PERF_FANOUT_MESSAGES * r["extra"]["subscribers"]
                and r["extra"]["drops"] == 0 for r in host_recs["fanout"]),
            "fanout: a message was lost")

    cli.join(timeout=330)
    proc, cli_wall = cli_box.get("bench run", (None, 0.0))
    require(proc is not None and proc.returncode == 0,
            "bench run: " + (f"exited {proc.returncode}: {proc.stderr[-2000:]}"
                             if proc is not None else "no exit in 300 s"))
    for line in proc.stdout.strip().splitlines():
        log(f"[perf] (5o c) bench run: {line}")
    read = read_ledger(ledger)
    records = read.records
    require(not read.skipped and all(r["provenance"]["platform"] == platform for r in records),
            f"the ledger: {read.skipped}")
    cli_configs = (f"harness.{PERF_CLI_CONFIG}", f"harness.{PERF_CLI_CONFIG}.pipeline-lag")
    cli_recs = [r for r in records if r["config"] in cli_configs]
    require([r["config"] for r in cli_recs] == list(cli_configs),
            f"bench run appended {[r['config'] for r in cli_recs]}")
    results = compare_ledger(records)
    rc, text = _quiet(bench_main, ["compare", "--ledger", ledger])
    want_rc = max(r.rc for r in results)
    require(rc == want_rc != 3 and text.strip() == render_compare(results),
            f"bench compare: exit {rc}, expected {want_rc}")
    rc_report, report_text = _quiet(bench_main, ["report", "--ledger", ledger, "--last", "0"])
    require(rc_report == 0 and report_text.strip() == render_report(records, last=0).strip(),
            "bench report differs from render_report")
    for line in text.strip().splitlines():
        if not line.startswith("----"):  # series with a baseline
            log(f"[perf] (5o c) bench compare: {line}")
    log(f"[perf] (5o c) bench run --config {PERF_CLI_CONFIG}: exit 0 in {cli_wall:.1f} s of "
        f"process, beside 5o(b) ({cli_recs[0]['value']:.1f} "
        f"{cli_recs[0]['unit']}); bench compare exit {rc} ({len(results)} series), bench "
        f"report {len(records)} records")
    out.update(cli={"wall_s": cli_wall, "value": cli_recs[0]["value"],
                    "stages": cli_recs[0]["stages"]},
               compare_rc=rc, records=len(records), seconds=time.perf_counter() - t_phase)
    log(f"[perf] phase 5o took {out['seconds']:.1f} s; launches {out['launches']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from inspektor_gadget_tpu_torch import models as M
    from inspektor_gadget_tpu_torch.device import device_report, time_cuda
    from inspektor_gadget_tpu_torch.native import build_all
    from inspektor_gadget_tpu_torch.ops import kernels as K
    from inspektor_gadget_tpu_torch.parallel import flash_attention as FA
    from inspektor_gadget_tpu_torch.ops import sketches as S
    from inspektor_gadget_tpu_torch.ops.hashing import _row_multiplier, hashed_bucket
    from inspektor_gadget_tpu_torch.sources import H2DStager, PinnedBufferPool, ZipfFoldedSource
    from inspektor_gadget_tpu_torch.sources import bridge
    from inspektor_gadget_tpu_torch.sources.synthetic import DISTINCT, HH, LANES, VALUES, WEIGHTS

    batch, prod = S.PRODUCTION_BATCH, S.PRODUCTION_GEOMETRY
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report: dict = {}

    # -- 1. device -------------------------------------------------------------
    rep = device_report(dev)
    log(f"[device] {rep['nvidia_smi']}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{rep['kind']} x{rep['count']}")
    report["device"] = rep

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    harnesses = stress_harnesses()
    build_all([K.LIBRARY, FA.LIBRARY, bridge.LIBRARY, *harnesses.values()])
    build_s = time.perf_counter() - t0
    for lib in (K.LIBRARY, FA.LIBRARY):
        log(f"[build] {lib.path.name} (nvcc {lib.build_seconds:.1f} s)")
        for line in lib.build_log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    log(f"[build] {bridge.LIBRARY.path.name} (g++ {bridge.LIBRARY.build_seconds:.1f} s)")
    log("[build] " + ", ".join(f"{h.binary_path().name} (g++ {h.build_seconds:.1f} s)"
                               for h in harnesses.values()))
    log(f"[build] all {3 + len(harnesses)} in {build_s:.1f} s")
    report["build_s"] = build_s
    hmma = hmma_count(FA.LIBRARY.path)
    log(f"[build] {FA.LIBRARY.path.name}: {hmma} HMMA instructions in its SASS")
    require(hmma > 0, "K3's bfloat16 kernel has no tensor-core instruction")
    report["k3_hmma"] = hmma

    # -- the card's host: what later phases and ROADMAP items need of it ---------
    facts = host_facts()
    log(f"[host] cards: torch.cuda.device_count() {facts['device_count']}")
    log(f"[host] grpc imports: {facts['grpc']}; google.protobuf imports: "
        f"{facts['google.protobuf']} (the CRI client needs both)")
    log(f"[host] root: {facts['root']}; unshare -m works: {facts['unshare']}; the proc-exec "
        f"source reports a child's execs: {facts['proc_exec']} "
        f"({facts['proc_exec_seen']} seen)"
        + (f" ({facts['proc_exec_error']})" if "proc_exec_error" in facts else ""))
    log(f"[host] the localmanager's procfs scan (localmanager.init): "
        f"{facts['procfs_scan_s'] * 1e3:.1f} ms, {facts['procfs_containers']} containers")
    log("[host] trace windows: " + ", ".join(f"{p} {facts[p]}" for p in WINDOW_PROBES)
        + f"; /dev/kmsg readable {facts['kmsg_readable']}; /proc/diskstats readable "
        f"{facts['diskstats']}; CAP_NET_RAW {facts['cap_net_raw']}"
        f"; ptrace {facts['ptrace']}")
    report["host"] = facts

    src = ZipfFoldedSource(args.seed + 1)
    host = src.generate(batch, valid=batch - 4321)
    host[WEIGHTS, ::7] *= 3
    host[WEIGHTS, ::13] = 0
    g = (1 + prod["quantile_alpha"]) / (1 - prod["quantile_alpha"])
    rng = np.random.default_rng(args.seed)
    edge = np.floor(g ** rng.integers(0, 1100, batch // 2)) + rng.integers(-1, 2, batch // 2)
    host[VALUES, : batch // 2] = np.clip(edge, 0, 2**32 - 1).astype(np.uint32)
    lanes = torch.from_numpy(host.view(np.int32)).to(dev)
    hh, distinct, dist, w, values = (lanes[j] for j in range(LANES))
    errs = {"K1": 0, "K2": 0, "K3": 0.0}

    def stress_lanes(n: int, kind: str) -> torch.Tensor:
        """A (5, n) batch on the card whose lanes are rows of one tensor
        (for odd n, rows 1-4 start off 16 bytes): the zipf stream, one
        hot key in every row, or weights near 2**31 that wrap."""
        blk = ZipfFoldedSource(args.seed + 7).generate(n, valid=n - n // 9)
        if kind == "hot key":
            blk[HH] = blk[2] = blk[HH, 0]
            blk[DISTINCT] = blk[DISTINCT, 0]
        elif kind == "weights near 2**31":
            blk[WEIGHTS] = rng.choice(np.array([2**31 - 1, 2**31, 2**31 - 3, 1], np.uint32), n)
        return torch.from_numpy(blk.view(np.int32)).to(dev)

    stress = [(f"{kind}, n {n}", n, kind) for n, kind in (
        (batch, "hot key"), (batch, "weights near 2**31"), (100003, "zipf"), (33, "zipf"),
        (100003, "hot key"))]

    # -- 3. K1 against its plain version --------------------------------------
    mult = int(_row_multiplier(0))
    k1_cases = [(f"log2 width {lw}", lw, lanes) for lw in (12, 16)]
    k1_cases += [(f"log2 width {lw}, {name}", lw, stress_lanes(n, kind))
                 for lw in (12, 16, 17) for name, n, kind in stress]
    for name, lw, t in k1_cases:
        got = K.histogram(t[2], t[WEIGHTS], log2_width=lw, mult=mult, salt=0)
        want = K.histogram_plain(t[2], t[WEIGHTS], log2_width=lw, mult=mult, salt=0)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["K1"] = max(errs["K1"], err)
        require(torch.equal(got, want), f"K1 at {name}: max abs err {err}")
        log(f"[K1] {name}: equal to the plain version ({int(got.sum())} weight)")

    # -- 4. K2 against its plain version --------------------------------------
    full = S.bundle_init(**prod, device=dev).geometry()
    no_inv = dict(inv_rows=0, inv_log2_buckets=0)
    plane_sets = {"base": dataclasses.replace(full, qt_buckets=0, **no_inv),
                  "+invertible": dataclasses.replace(full, qt_buckets=0),
                  "+quantiles": dataclasses.replace(full, **no_inv), "both": full}
    k2_cases = [(name, geom, lanes) for name, geom in plane_sets.items()]
    k2_cases += [(name, full, stress_lanes(n, kind)) for name, n, kind in stress]
    k2_cases += [(f"count-min log2 width {lw}", dataclasses.replace(full, log2_width=lw), lanes)
                 for lw in (18, 20)]
    k2_cases.append(("HLL p 16", dataclasses.replace(full, hll_p=16), lanes))
    for name, geom, t in k2_cases:
        got = K.fused_planes(t[HH], t[DISTINCT], t[2], t[WEIGHTS], t[VALUES], geom)
        want = K.fused_planes_plain(t[HH], t[DISTINCT], t[2], t[WEIGHTS], t[VALUES], geom)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["K2"] = max(errs["K2"], err)
        require(torch.equal(got, want), f"K2 {name}: max abs err {err}")
        log(f"[K2] {name}: {len(geom.planes)} planes, {geom.total} buckets, n {t.shape[1]}, "
            f"equal to the plain version")

    # the launch plans of the main paths' shapes
    ent_plane = K.Plane(K.HIST64, K.LANE_HH, mult, 0, prod["entropy_log2_width"],
                        1 << prod["entropy_log2_width"], 0)
    report["plans"] = {}
    for name, planes in (("K1", (ent_plane,)), ("K2", full.planes)):
        plan = K.launch_plan(planes, batch, K.sm_count(dev))
        info = dict(plan.summary(), blocks_per_sm=K.plan_occupancy(plan))
        report["plans"][name] = info
        log(f"[plan] {name} at batch {batch}: {info}")
        require(info["blocks"] >= K.sm_count(dev) and info["blocks_per_sm"] >= 1,
                f"{name}'s production plan leaves SMs idle: {info}")

    # -- 5. the main path --------------------------------------------------------
    warm, steps = 4, 64
    total_steps = warm + steps
    bundle = S.bundle_init(**prod, device=dev)
    pool = PinnedBufferPool(batch, lanes=LANES, max_free=8, device=dev)
    stager = H2DStager(pool, depth=4, device=dev)
    q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()
    producer_error: list[Exception] = []

    def producer() -> None:
        try:
            psrc = ZipfFoldedSource(args.seed)
            i = 0
            while not stop.is_set():
                blk = pool.get()
                fill_block(psrc, blk.numpy(), i)
                i += 1
                while not stop.is_set():
                    try:
                        q.put(blk, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # reported by the consumer below
            producer_error.append(e)

    # path 1, staged ingest: pool -> stager -> bundle_ingest_step (K2)
    reset_launches()
    producer_thread = threading.Thread(target=producer, daemon=True)
    producer_thread.start()
    t_start = None
    for i in range(total_steps):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        blk = q.get(timeout=60)
        staged = stager.stage(blk, tuple(blk[j] for j in range(LANES)))
        bundle, fence = S.bundle_ingest_step(bundle, staged[HH], staged[DISTINCT],
                                             staged[2], staged[WEIGHTS], values=staged[VALUES])
        stager.fence(fence)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t_start
    ingest_launches = read_launches()
    stop.set()
    producer_thread.join(timeout=10)
    require(not producer_thread.is_alive() and not producer_error, f"producer: {producer_error}")
    stager.drain()
    e2e_ev_s = steps * batch / e2e_s
    log(f"[main] ingest: {total_steps} batches x {batch} events staged and ingested; "
        f"launches K2={ingest_launches['K2']} K1={ingest_launches['K1']}")
    require(ingest_launches == {"K1": 0, "K2": total_steps, "K3": 0},
            f"ingest launched {ingest_launches}, expected K2 once a step and no K1")

    def plain_fold(device, on_block=None):
        """The same stream folded by the plain composition `bundle_update`."""
        out = S.bundle_init(**prod, device=device)
        rsrc = ZipfFoldedSource(args.seed)
        blk = np.empty((LANES, batch), np.uint32)
        for i in range(total_steps):
            fill_block(rsrc, blk, i)
            t = torch.from_numpy(blk.view(np.int32)).to(device)
            S.bundle_update(out, t[HH], t[DISTINCT], t[2], t[WEIGHTS], values=t[VALUES])
            if on_block is not None:
                on_block(blk)
        return out

    # path 2, the plain composition on the card: its entropy update is K1
    reset_launches()
    composed = plain_fold(dev)
    compose_launches = read_launches()
    log(f"[main] plain composition on the card: launches K1={compose_launches['K1']} "
        f"K2={compose_launches['K2']}")
    require(compose_launches == {"K1": total_steps, "K2": 0, "K3": 0},
            f"bundle_update launched {compose_launches}, expected K1 once a step and no K2")
    launches = {"K1": compose_launches["K1"], "K2": ingest_launches["K2"]}

    # the reference: the same fold on the CPU, where every wrapper takes its
    # plain version, so no kernel enters the comparison
    exact_hh, exact_distinct, weight_sum = [], [], 0

    def tally(blk: np.ndarray) -> None:
        nonlocal weight_sum
        exact_hh.append(np.repeat(blk[HH], blk[WEIGHTS]))
        exact_distinct.append(blk[DISTINCT][blk[WEIGHTS] != 0])
        weight_sum += int(blk[WEIGHTS].sum(dtype=np.int64))

    reset_launches()
    t0 = time.perf_counter()
    reference = plain_fold(torch.device("cpu"), tally)
    log(f"[main] reference fold on the CPU in {time.perf_counter() - t0:.1f} s")
    require(read_launches() == {"K1": 0, "K2": 0, "K3": 0},
            "the CPU reference launched a kernel")
    ref_leaves = S.bundle_to_numpy(reference)
    for name, b in (("ingested", bundle), ("composed", composed)):
        for i, (x, y) in enumerate(zip(S.bundle_to_numpy(b), ref_leaves)):
            require(x.dtype == y.dtype and np.array_equal(x, y),
                    f"{name} bundle vs the CPU reference: leaf {i} differs")
    log("[main] the ingested and the composed bundle each equal the CPU reference, leaf by leaf")

    events, drops, distinct_est, ent_bits, overflow, keys, counts = S.decode_digest(
        S.bundle_digest(bundle))
    require(events == float(weight_sum), f"events {events} != {weight_sum}")
    exact_keys, exact_counts = np.unique(np.concatenate(exact_hh), return_counts=True)
    order = np.argsort(-exact_counts, kind="stable")[:10]
    found = dict(zip(keys.tolist(), counts.tolist()))
    for kk, cc in zip(exact_keys[order], exact_counts[order]):
        require(found.get(int(kk), -1) >= cc, f"heavy hitter {kk:#010x}: "
                f"{found.get(int(kk))} < exact {cc}")
    require(int(keys[0]) == int(exact_keys[order[0]]), "top heavy hitter differs")
    true_distinct = np.unique(np.concatenate(exact_distinct)).size
    require(abs(distinct_est - true_distinct) / true_distinct < 0.05,
            f"HLL {distinct_est} vs exact {true_distinct}")
    require(all(np.isfinite([events, distinct_est, ent_bits])), "non-finite digest")
    log(f"[main] events {events:.0f}, distinct ~{distinct_est:.0f} (exact {true_distinct}), "
        f"entropy {ent_bits:.4f} bits, candidate overflow {overflow}")
    log("[main] heavy hitters (key, count, exact): " + ", ".join(
        f"{int(k):#010x}:{int(c)}:{found_exact}" for k, c, found_exact in zip(
            keys[:8], counts[:8],
            [int(exact_counts[exact_keys == k][0]) if (exact_keys == k).any() else 0
             for k in keys[:8]])))

    # device-only rate: pre-staged device batches, the same step
    dbundle = S.bundle_init(**prod, device=dev)
    dsrc = ZipfFoldedSource(args.seed + 2)
    pre = [torch.from_numpy(dsrc.generate(batch).view(np.int32)).to(dev) for _ in range(8)]
    for i in range(warm):
        S.bundle_ingest_step(dbundle, pre[i][HH], pre[i][DISTINCT], pre[i][2],
                             pre[i][WEIGHTS], values=pre[i][VALUES])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        p = pre[i % 8]
        S.bundle_ingest_step(dbundle, p[HH], p[DISTINCT], p[2], p[WEIGHTS], values=p[VALUES])
    torch.cuda.synchronize()
    device_ev_s = steps * batch / (time.perf_counter() - t0)
    log(f"[main] end-to-end {e2e_ev_s:.0f} events/s over {steps} batches "
        f"(pool hits {pool.hits}, misses {pool.misses}); device-only {device_ev_s:.0f} events/s")

    # -- 5b. the capture leg: NativeCapture -> pool -> stager -> K2 + window
    # steps -> harvest, at a vocabulary under the decode's capacity and over it
    from inspektor_gadget_tpu_torch.telemetry import REGISTRY, PipelineStats

    def pool_counts() -> tuple[float, float]:
        return tuple(REGISTRY.counter(f"ig_ingest_pool_{x}_total", labels=("lane",))
                     .labels(lane="0").value for x in ("hits", "misses"))

    capture: dict = {"native_build_s": bridge.LIBRARY.build_seconds}
    for label, vocab in (("under capacity", 2000), ("over capacity", 20000)):
        run = CaptureRun(args.seed + 11, vocab, batch, prod)
        stats = PipelineStats(f"chip-smoke-{vocab}")
        hits0, misses0 = pool_counts()
        reset_launches()
        info = run.drive(dev, CAPTURE_BATCHES, stats)
        launched = read_launches()
        require(launched == {"K1": 0, "K2": info["batches"], "K3": 0},
                f"capture run ({label}) launched {launched}, expected K2 once a batch")
        launches["K2"] += launched["K2"]
        hits1, misses1 = pool_counts()
        info.update(vocab=vocab, launches=launched, starved=stats.starved,
                    saturated=stats.saturated, stall_s=stats.stall_s,
                    pool_hits=hits1 - hits0, pool_misses=misses1 - misses0)
        log(f"[capture] {label}: vocab {vocab}, {info['events']} events in {info['batches']} "
            f"batches ({info['full_batches']} full), {info['harvests']} harvests; launches "
            f"{launched}; drops 0")
        log(f"[capture] {label}: end-to-end {info['e2e_ev_per_s']:.0f} events/s with harvests, "
            f"{info['ingest_ev_per_s']:.0f} without; native source "
            f"{info['source_ev_per_s'] or 0:.0f} events/s (phase 5's Python source end to end: "
            f"{e2e_ev_s:.0f})")
        log(f"[capture] {label}: stager ticks starved {stats.starved}, saturated "
            f"{stats.saturated} (stall {stats.stall_s * 1e3:.2f} ms); pool hits "
            f"{info['pool_hits']:.0f}, misses {info['pool_misses']:.0f} (registry)")
        dec = info["decodes"][-1]
        log(f"[capture] {label}: harvest device loop {info['harvest_device_ms']:.2f} ms, host "
            f"finisher {info['harvest_host_ms']:.2f} ms a harvest; last decode recovered "
            f"{dec['recovered']} keys, complete {dec['complete']}, {dec['sweeps']} host "
            f"sweeps, residual {dec['residual_events']} events")
        t0 = time.perf_counter()
        cpu_harvests, cpu_final, cpu_window, keys = run.fold_cpu()
        info["cpu_fold_s"] = time.perf_counter() - t0
        require(len(cpu_harvests) == len(run.harvests) == info["batches"] // HARVEST_EVERY,
                f"capture run ({label}): {len(run.harvests)} harvests")
        for h, (got, want) in enumerate(zip(run.harvests, cpu_harvests)):
            # the digest bit for bit: its integer words (events, drops,
            # overflow, top-k) and its distinct and entropy estimates, which
            # follow XLA's CPU float32 arithmetic on every device
            gd, wd = got["digest"].view(np.uint32), want["digest"].view(np.uint32)
            require(gd.shape == wd.shape and np.array_equal(gd, wd),
                    f"capture run ({label}), harvest {h}: digest differs from the CPU fold "
                    f"(distinct, entropy {gd[2:4].view(np.float32)} vs "
                    f"{wd[2:4].view(np.float32)})")
            for field in ("buffer", "residual", "wcms", "whll"):
                g, w_ = (got[field], want[field]) if field in ("buffer", "residual") else \
                    ([got[field]], [want[field]])
                require(all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(g, w_)),
                        f"capture run ({label}), harvest {h}: {field} differs from the CPU fold")
            require(got["decode"] == want["decode"] and got["n"] == want["n"]
                    and got["epoch"] == want["epoch"],
                    f"capture run ({label}), harvest {h}: InvDecode differs from the CPU fold")
        for i, (x, y) in enumerate(zip(run.final, cpu_final)):
            require(x.dtype == y.dtype and np.array_equal(x, y),
                    f"capture run ({label}): bundle leaf {i} differs from the CPU fold")
        require(all(np.array_equal(x, y) for x, y in zip(run.final_window, cpu_window)),
                f"capture run ({label}): window leaves differ from the CPU fold")
        # the events the last harvest saw: every batch up to it
        seen = sum(run.counts[:HARVEST_EVERY * len(run.harvests)])
        uniq, cnt = np.unique(keys[:seen], return_counts=True)
        tally = dict(zip(uniq.tolist(), cnt.tolist()))
        last = run.harvests[-1]["decode"]
        require(all(tally.get(k) == c for k, c in last["keys"]),
                f"capture run ({label}): a decoded count differs from the exact tally")
        if label == "under capacity":
            require(last["complete"] and last["recovered"] == len(tally),
                    f"capture run ({label}): decode incomplete ({last['recovered']} of "
                    f"{len(tally)} keys)")
        info.update(distinct=len(tally), complete=last["complete"],
                    recovered=last["recovered"], residual_events=last["residual_events"])
        capture[label] = info
        log(f"[capture] {label}: every harvest's digest, decode buffer, residual and "
            f"InvDecode, the window leaves and the bundle equal the CPU fold of the stream "
            f"rebuilt from the seed ({info['cpu_fold_s']:.1f} s); the {last['recovered']} "
            f"decoded counts equal the exact tally of {len(tally)} keys")

    # device-only events/s of the step alone and with the two window steps
    # (pre-staged batches of the native stream, one call, back to back)
    nsrc = bridge.NativeCapture(bridge.SRC_SYNTH_EXEC, seed=args.seed + 12, vocab=2000)
    pre_k = [torch.from_numpy(nsrc.generate_folded(batch).view(np.int32)).to(dev)
             for _ in range(8)]
    t0 = time.perf_counter()
    nsrc.generate_folded(batch * 8)
    native_fill = batch * 8 / (time.perf_counter() - t0)
    nsrc.close()
    ones = torch.ones(batch, dtype=torch.int32, device=dev)
    zeros = torch.zeros(batch, dtype=torch.int32, device=dev)
    from inspektor_gadget_tpu_torch.ops import hll_init
    from inspektor_gadget_tpu_torch.ops import window as W
    rates = {}
    for name, windows in (("step", False), ("step + window steps", True),
                          ("step again", False)):
        dbundle = S.bundle_init(**prod, device=dev)
        wcms, whll = W.wcms_init(**WINDOW, device=dev), hll_init(prod["hll_p"], device=dev)
        for i in range(warm + steps):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            k = pre_k[i % 8]
            S.bundle_ingest_step(dbundle, k, k, k, ones, values=zeros)
            if windows:
                W.wcms_ingest_step(wcms, k, ones)
                W.hll_ingest_step(whll, k, ones)
        torch.cuda.synchronize()
        rates[name] = steps * batch / (time.perf_counter() - t0)
    capture.update(device_only=rates, native_generate_folded_ev_per_s=native_fill)
    log(f"[capture] device-only events/s: " + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
        + f"; native generate_folded fills {native_fill:.0f} events/s on one host thread")
    report["capture"] = capture

    # -- 5c. the operator: TpuSketchInstance through its entry points ------------
    from inspektor_gadget_tpu_torch.telemetry import snapshot
    ckpt_root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    op_run = OperatorRun(args.seed + 21, 2000, batch, prod,
                         ckpt_root.parent / "chip_smoke_hist")
    before = snapshot()
    reset_launches()
    with pinned_zip_clock(1.7e9):
        op_rec, op_info = op_run.drive(dev, CAPTURE_BATCHES, ckpt_root / "gpu")
    launched = read_launches()
    after = snapshot()
    hist_bytes = after["ig_history_bytes_total"] - before.get("ig_history_bytes_total", 0.0)
    wkey = 'ig_history_windows_total{type="9"}'
    hist_windows = after[wkey] - before.get(wkey, 0.0)
    n_ingest = op_info["folded_batches"] + OP_EVENT_BATCHES
    require(launched == {"K1": 0, "K2": n_ingest, "K3": 0},
            f"operator run launched {launched}, expected K2 {n_ingest} (once an ingest)")
    launches["K2"] += launched["K2"]
    t0 = time.perf_counter()
    with pinned_zip_clock(1.7e9):
        cpu_rec = op_run.replay(torch.device("cpu"), ckpt_root / "cpu")
    op_info["cpu_replay_s"] = time.perf_counter() - t0
    op_info.update(launches=launched, worst=compare_operator_runs(
        op_rec, cpu_rec, ckpt_root / "gpu", ckpt_root / "cpu"))
    n_a = -(-op_info["folded_batches"] // HARVEST_EVERY)  # harvests of feed (a)
    seen = sum(op_run.counts[:HARVEST_EVERY])
    uniq, cnt = np.unique(op_run.keys[:seen], return_counts=True)
    first = op_rec["summaries"][0]
    require(first.inv["complete"] and first.decoded == sorted(
        zip(uniq.tolist(), cnt.tolist()), key=lambda kv: (-kv[1], kv[0])),
            "operator: the first harvest's decode differs from the exact tally")
    for sm in op_rec["summaries"]:
        require(all(np.isfinite([sm.distinct, sm.entropy_bits])) and sm.events > 0
                and len(sm.heavy_hitters) == prod["k"] and set(sm.classes) == {"hot", "rest"},
                f"operator: harvest {sm.epoch} is malformed")
    require(op_rec["summaries"][-1].anomaly is not None
            and len(op_rec["summaries"][-1].anomaly) == OP_CONTAINERS
            and all(np.isfinite(list(op_rec["summaries"][-1].anomaly.values()))),
            "operator: the seq scorer did not score every container")
    hm = op_info["harvest_ms"]
    log(f"[operator] feed (a): {op_info['folded_events']} events in "
        f"{op_info['folded_batches']} batches ({op_info['full_batches']} full) through "
        f"folded_block -> pop_folded -> ingest_folded, {n_a} harvests; launches {launched}")
    log(f"[operator] feed (a): end-to-end {op_info['folded_e2e_ev_per_s']:.0f} events/s with "
        f"harvests and seals, {op_info['folded_ingest_ev_per_s']:.0f} without; phase 5b's "
        f"hand-driven path at vocab 2000 in this run: "
        f"{capture['under capacity']['e2e_ev_per_s']:.0f} with harvests, "
        f"{capture['under capacity']['ingest_ev_per_s']:.0f} without")
    log(f"[operator] feed (b): {op_info['event_batch_events']} events in {OP_EVENT_BATCHES} "
        f"EventBatches through enrich_batch, {op_info['event_batch_e2e_ev_per_s']:.0f} events/s "
        f"with 2 harvests, their seals and the checkpoint")
    for i, h in enumerate(hm):
        log(f"[operator] harvest {i + 1}: " + ", ".join(f"{k} {v:.2f}" for k, v in h.items())
            + " ms (digest + device decode, host finisher and reads, seq step, seal)")
    last = op_rec["summaries"][-1]
    log(f"[operator] last harvest: events {last.events}, drops {last.drops}, distinct "
        f"~{last.distinct:.0f}, inv {last.inv}, classes "
        f"{ {k: (v['recovered'], v['complete']) for k, v in last.classes.items()} }, "
        f"p99 {last.quantiles['p99']:.0f}, accuracy ratio {last.accuracy['ratio']:.3g}")
    hstore = op_info["worst"]["store"]
    require(hist_windows == op_info["windows"] > 0,
            f"operator: {hist_windows} windows appended, {op_info['windows']} in the store")
    sm = op_info["seal_ms"]
    split = {k: sum(x[k] for x in sm) / len(sm) for k in sm[0]}
    op_info["history"] = {"windows": hist_windows, "bytes": hist_bytes,
                          "bytes_per_window": hist_bytes / hist_windows, "seal_ms_mean": split,
                          **hstore}
    log(f"[history] (5e a) the card's store: {hist_windows:.0f} windows sealed, "
        f"{hist_bytes:.0f} bytes appended (ig_history_bytes_total), "
        f"{hist_bytes / hist_windows:.0f} bytes a window; {hstore['segments']} segments, "
        f"{hstore['index_rows']} index rows; every segment byte-identical to the CPU "
        f"instance's store, index rows equal but sealed_ts")
    log(f"[history] (5e a) seal per window, mean of {len(sm)}: " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()) + " ms (reads off the card and the window's "
        "build, digest + encode_window, the store append, the standing-query fold)")
    log(f"[history] (5e a) {op_info['worst']['standing_answers']} standing answers "
        f"({', '.join(q['id'] for q in STANDING_QUERIES)}) equal card vs CPU, header and payload "
        f"bytes, and each equal to answer_query over the store's windows in its range")
    log(f"[operator] {len(op_rec['summaries'])} summaries, {hist_windows:.0f} sealed "
        f"windows and the checkpoint equal the CPU instance's on the same streams "
        f"({op_info['cpu_replay_s']:.1f} s); seq scores within "
        f"{op_info['worst']['anomaly_nats']:.3g} nats, scorer leaves within "
        f"{op_info['worst']['scorer_leaf_rel']:.3g} of each leaf's scale; the first decode "
        f"equals the exact tally of "
        f"{len(uniq)} keys")
    report["operator"] = op_info

    # -- 5d. the gadget framework: trace/exec with the sketch plane --------------
    # (a) LocalRuntime on the card, then the same seeded run on the CPU
    reset_launches()
    g_card = gadget_run("cuda", GADGET_BATCHES, batch)
    launched = read_launches()
    require(launched == {"K1": 0, "K2": GADGET_BATCHES, "K3": 0},
            f"gadget run launched {launched}, expected K2 {GADGET_BATCHES} (once a batch)")
    launches["K2"] += launched["K2"]
    g_cpu = gadget_run("cpu", GADGET_BATCHES, batch)
    gsum, csum = g_card["summary"], g_cpu["summary"]
    ae_gap = compare_summaries(gsum, csum, "gadget run, card vs CPU", anomaly_rel=5e-2)
    require(gsum.events == GADGET_BATCHES * batch and gsum.inv is not None
            and gsum.quantiles is not None and gsum.accuracy is not None
            and len(gsum.heavy_hitters) == prod["k"] and gsum.anomaly
            and all(np.isfinite(list(gsum.anomaly.values()))),
            "gadget run: the final summary is malformed")
    log(f"[gadget] (a) LocalRuntime trace/exec, pysynthetic seed 7, {GADGET_BATCHES} x {batch} "
        f"events, every plane on: card {g_card['ev_per_s']:.0f} events/s end to end "
        f"({g_card['seconds']:.2f} s, harvest {g_card['harvest_ms']:.1f} ms), CPU "
        f"{g_cpu['ev_per_s']:.0f} ({g_cpu['seconds']:.2f} s); launches {launched}")
    log(f"[gadget] (a) final summary equal to the CPU run's: events {gsum.events}, distinct "
        f"~{gsum.distinct:.0f}, entropy {gsum.entropy_bits:.4f} b, inv {gsum.inv}, p99 "
        f"{gsum.quantiles['p99']:.0f}, {len(gsum.anomaly)} containers scored (ae within "
        f"{ae_gap:.3g} of a score)")
    # (b) the CLI as a user runs it, on the native synthetic source
    cli = cli_run("cuda", batch, CLI_SECONDS, ckpt_root.parent / "chip_smoke_cli.json",
                  GADGET_SKETCH)
    ep = cli["epochs"]
    require(len(ep) >= 5 and all(e["heavy_hitters"] > 0 for e in ep),
            f"CLI run: {len(ep)} sketch epochs, heavy hitters {[e['heavy_hitters'] for e in ep]}")
    require(cli["k2_launches"] == cli["steps"] > 0,
            f"CLI run: K2 launched {cli['k2_launches']} times over {cli['steps']} steps")
    launches["K2"] += cli["k2_launches"]
    cli["ev_per_s"] = ep[-1]["events"] / cli["run_s"]
    cli["batches_ev_per_s"] = ep[-1]["events"] / cli["batches_s"]
    log(f"[gadget] (b) CLI trace exec --device cuda --source synthetic --rate 30000000 "
        f"--timeout {CLI_SECONDS}: exit 0, {len(ep)} sketch epochs, last events "
        f"{ep[-1]['events']} in a {cli['run_s']:.2f} s run ({cli['process_s']:.1f} s of "
        f"process): {cli['ev_per_s']:.0f} events/s end to end; the run's set-up (to its first "
        f"batch) {cli['setup_s']:.2f} s, {cli['batches_ev_per_s']:.0f} events/s from the first "
        f"batch to the run's end; drops {ep[-1]['drops']} in the "
        f"last summary ({cli['source_drops']:.0f} counted at the source, "
        f"{cli['source_events']:.0f} popped); {cli['harvests']:.0f} harvests of "
        f"{cli['harvest_ms']:.1f} ms on average; h2d {cli['h2d_ms']:.2f} ms and update "
        f"{cli['update_ms']:.2f} ms a batch (host); K2 launched {cli['k2_launches']} times; "
        f"device idle share not measured here")
    log(f"[gadget] beside phase 5c in this run: its folded feed "
        f"{op_info['folded_e2e_ev_per_s']:.0f} events/s with harvests, enrich_batch "
        f"{op_info['event_batch_e2e_ev_per_s']:.0f}; the gadget run (a) "
        f"{g_card['ev_per_s']:.0f}, the CLI (b) {cli['ev_per_s']:.0f}")
    report["gadget"] = {"card": {k: v for k, v in g_card.items() if k != "summary"},
                        "cpu": {k: v for k, v in g_cpu.items() if k != "summary"},
                        "launches": launched, "ae_rel_gap": ae_gap, "cli": cli}

    # -- 5e (b). the history route through the CLI --------------------------------
    hist = history_route("cuda", batch, HISTORY_CLI_SECONDS, GADGET_SKETCH, ckpt_root.parent,
                         cli["ev_per_s"])
    hc = hist["cli_run"]
    require(hc["k2_launches"] == hc["steps"] > 0,
            f"CLI history run: K2 launched {hc['k2_launches']} times over {hc['steps']} steps")
    launches["K2"] += hc["k2_launches"]
    report["history"] = {"operator": op_info["history"], **hist}

    def time_kernels() -> dict:
        """K1, K2 and K3 at the main path's shapes, each as (ms, plain ms,
        library ms): K1 and K2 on the phase-5 batch and bundle geometry,
        K3 at the operator's window on inputs of a fixed seed."""
        g3 = torch.Generator(device=dev).manual_seed(args.seed + 5)
        geom = bundle.geometry()
        ent_lw = prod["entropy_log2_width"]
        mult0 = int(_row_multiplier(0))
        k1_ms = time_cuda(lambda: K.histogram(dist, w, log2_width=ent_lw, mult=mult0))
        k1_plain = time_cuda(lambda: K.histogram_plain(dist, w, log2_width=ent_lw, mult=mult0))
        idx = hashed_bucket(dist, mult0, 0, ent_lw)
        w_f = w.to(torch.float32)
        k1_lib = time_cuda(lambda: torch.bincount(idx, weights=w_f, minlength=1 << ent_lw))
        k2_ms = time_cuda(lambda: K.fused_planes(hh, distinct, dist, w, values, geom))
        k2_plain = time_cuda(lambda: K.fused_planes_plain(hh, distinct, dist, w, values, geom),
                             per_round=2, warm=2)
        # yardstick: one scatter_add_ of every additive plane's values at
        # precomputed flat indices (the hashes and the HLL max plane excluded)
        flat_idx, flat_val = [], []
        lane_t = (hh, distinct, dist, values)
        from inspektor_gadget_tpu_torch.ops.invertible import inv_lane_values
        from inspektor_gadget_tpu_torch.ops.quantiles import bucket_index
        inv_vals = inv_lane_values(hh, w)
        for pl in geom.planes:
            if pl.kind == K.HLL:
                continue
            if pl.kind == K.QUANT:
                ix = bucket_index(values, alpha=geom.qt_alpha, min_value=geom.qt_min_value,
                                  n_buckets=geom.qt_buckets)
                val = w.to(torch.int64)
            else:
                ix = hashed_bucket(lane_t[pl.lane], pl.mult, pl.salt, pl.log2_width)
                val = (w.to(torch.int64) if pl.kind in (K.HIST, K.HIST64)
                       else inv_vals[pl.kind - K.INV_COUNT])
            flat_idx.append(ix + pl.offset)
            flat_val.append(val)
        flat_idx, flat_val = torch.cat(flat_idx), torch.cat(flat_val)
        k2_lib = time_cuda(lambda: torch.zeros(geom.total, dtype=torch.int64, device=dev)
                           .scatter_add_(0, flat_idx, flat_val))
        q, k, v = k3_inputs((CONTAINERS, SEQ_WINDOW - 1, 4, 32), torch.bfloat16, g3, dev)
        k3_ms = time_cuda(lambda: FA.flash_attention(q, k, v))
        k3_plain = time_cuda(lambda: FA.flash_attention_plain(q, k, v), per_round=2, warm=2)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        k3_lib = time_cuda(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True))
        return {"K1": (k1_ms, k1_plain, k1_lib), "K2": (k2_ms, k2_plain, k2_lib),
                "K3": (k3_ms, k3_plain, k3_lib)}

    def log_times(when: str, times: dict) -> None:
        log(f"[time] {when}: " + "; ".join(
            f"{name} {t[0]:.4f} ms (plain {t[1]:.4f}, library {t[2]:.4f})"
            for name, t in times.items()))

    # the kernels' times before and after 5f's ~105 s of host and disk work
    report["kernel_times"] = {"before 5f": time_kernels()}
    log_times("the kernels before phase 5f", report["kernel_times"]["before 5f"])

    # -- 5f. capture, alerts and replay --------------------------------------------
    cap_root = ckpt_root.parent / "chip_smoke_capture"
    shutil.rmtree(cap_root, ignore_errors=True)
    t_cap = time.perf_counter()
    cap = capture_route("cuda", CAPTURE_ROUTE_BATCHES, batch, cap_root)
    launches["K2"] += cap["k2_launches"]
    cap_cli = capture_cli("cuda", batch, cap_root, cli["ev_per_s"])
    cc = cap_cli["cli_run"]
    require(cc["k2_launches"] == cc["steps"] > 0,
            f"CLI capture run: K2 launched {cc['k2_launches']} times over {cc['steps']} steps")
    launches["K2"] += cc["k2_launches"]
    reset_launches()
    ent = entropy_journal("cuda", batch, cap_root, ckpt_root.parent / ENTROPY_JOURNAL)
    ent["k2_launches"] = read_launches()["K2"]
    require(ent["k2_launches"] == ENTROPY_BATCHES,
            f"entropy journal: K2 {ent['k2_launches']} launches over {ENTROPY_BATCHES} batches")
    launches["K2"] += ent["k2_launches"]
    report["capture"] = {**cap, "cli": cap_cli, "entropy": ent,
                         "seconds": time.perf_counter() - t_cap}
    log(f"[capture] phase 5f took {report['capture']['seconds']:.1f} s")
    perf_journal = ckpt_root.parent / PERF_JOURNAL  # 5o replays 5f(a)'s recording
    shutil.rmtree(perf_journal, ignore_errors=True)
    shutil.move(cap["journal"], perf_journal)
    shutil.rmtree(cap_root, ignore_errors=True)  # hundreds of MB of journals
    report["kernel_times"]["after 5f"] = time_kernels()
    log_times("the kernels after phase 5f", report["kernel_times"]["after 5f"])

    # -- 5g. container scoping ------------------------------------------------------
    t_scoped = time.perf_counter()
    scoped = scoped_route("cuda", batch, g_card["ev_per_s"])
    launches["K2"] += scoped["k2_launches"] + scoped["native"]["k2_launches"]
    scoped["black_box"] = scoped_cli("cuda", facts, ckpt_root.parent / "chip_smoke_black_box")
    launches["K2"] += scoped["black_box"].get("k2_launches", 0)
    scoped["seconds"] = time.perf_counter() - t_scoped
    log(f"[containers] phase 5g took {scoped['seconds']:.1f} s")
    report["containers"] = scoped

    # -- 5h. the trace gadget family ------------------------------------------------
    t_trace = time.perf_counter()
    trace = trace_family("cuda", batch, g_card["ev_per_s"])
    launches["K2"] += sum(d["k2_launches"] for d in trace["sketched"].values())
    trace["real"] = real_windows("cuda", facts)
    launches["K2"] += sum(d.get("k2_launches", 0) for d in trace["real"].values())
    trace["seconds"] = time.perf_counter() - t_trace
    log(f"[trace] phase 5h took {trace['seconds']:.1f} s")
    report["trace"] = trace

    # -- 5i. the remaining gadgets (ROADMAP 17b) -----------------------------------
    t_17b = time.perf_counter()
    rem = {"syscall": syscall_gadgets("cuda", batch, g_card["ev_per_s"])}
    launches["K2"] += sum(d["k2_launches"] for d in rem["syscall"].values())
    rem["real"] = remaining_windows("cuda", facts, ckpt_root.parent / "chip_smoke_17b")
    launches["K2"] += sum(d.get("k2_launches", 0) for d in rem["real"].values())
    rem["seconds"] = time.perf_counter() - t_17b
    log(f"[17b] phase 5i took {rem['seconds']:.1f} s")
    report["remaining"] = rem

    # -- 5j. the agent (ROADMAP 18a) ---------------------------------------------------
    t_agent = time.perf_counter()
    agent = agent_route("cuda", batch, ckpt_root.parent / "chip_smoke_agent", g_card["ev_per_s"])
    launches["K2"] += agent["k2_launches"]
    agent["cli"] = agent_cli("cuda", batch, ckpt_root.parent / "chip_smoke_agent_cli")
    agent["seconds"] = time.perf_counter() - t_agent
    log(f"[agent] phase 5j took {agent['seconds']:.1f} s")
    report["agent"] = agent

    # -- 5k. the fan-out (ROADMAP 18b) ------------------------------------------------
    t_fan = time.perf_counter()
    fan = fanout_route("cuda", batch, ckpt_root.parent / "chip_smoke_fanout",
                       agent["shared"]["ev_per_s"])
    launches["K2"] += fan["k2_launches"]
    fan["cli"] = fanout_cli("cuda", ckpt_root.parent / "chip_smoke_fanout_cli")
    fan["seconds"] = time.perf_counter() - t_fan
    log(f"[fanout] phase 5k took {fan['seconds']:.1f} s")
    report["fanout"] = fan

    # -- 5l. sharded ingest, the collective merge, the fleet tier (ROADMAP 11) -------
    t_shard = time.perf_counter()
    shard = {"lanes": shard_lanes("cuda", batch, prod, args.seed + 11)}
    launches["K2"] += sum(d["k2_launches"] for d in shard["lanes"]["lanes"].values())
    nccl = start_nccl_merge("cuda", ckpt_root.parent / "chip_smoke_shard", args.seed + 12)
    shard["operator"] = shard_operator("cuda", batch)
    launches["K2"] += shard["operator"]["k2_launches"]
    shard["collective"] = finish_nccl_merge(nccl)
    shard["fleet_cli"] = fan["cli"].get("fleet_cli")
    shard["seconds"] = time.perf_counter() - t_shard
    log(f"[shard] phase 5l took {shard['seconds']:.1f} s (and 5l(d) ran inside 5k(b))")
    report["shard"] = shard

    # -- 5m. the doctor, the bounded CUDA probe, the stress harnesses (ROADMAP 19, 21)
    doctor = doctor_phase(facts, harnesses)
    log(f"[doctor] phase 5m took {doctor['seconds']:.1f} s")
    report["doctor"] = doctor

    # -- 5n. training-side parallelism over lanes of cuda:0 (ROADMAP 13) ------------
    par = parallel_phase(args.seed + 13, batch, prod)
    launches["K1"] += par["launches"]["K1"]
    report["parallel"] = par

    # -- 5o. the perf plane: harness arms, bench modules, `bench` (ROADMAP 20) ------
    perf = perf_phase("cuda", rep, ckpt_root.parent / "chip_smoke_perf", str(perf_journal))
    launches["K1"] += perf["launches"]["K1"]
    launches["K2"] += perf["launches"]["K2"]
    shutil.rmtree(perf_journal, ignore_errors=True)
    report["perf"] = perf

    # -- 6. K3 against its plain version ----------------------------------------
    # the plain versions' float32 matmuls run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    op_shape = (CONTAINERS, SEQ_WINDOW - 1, 4, 32)  # the operator's window, scored as T=255
    long_shape = (16, 4095, 4, 32)
    test_shapes = (  # tests/test_flash_attention.py
        ((2, 256, 4, 32), True), ((1, 200, 2, 16), False), ((2, 128, 1, 128), True),
        ((1, 384, 2, 64), True))
    k3_cases = [("operator window", op_shape, torch.bfloat16, True)]
    k3_cases += [(f"test shape {sh}", sh, dt, c) for dt in (torch.float32, torch.bfloat16)
                 for sh, c in test_shapes]
    k3_cases.append(("long window", long_shape, torch.bfloat16, True))
    report["k3_errors"] = []
    for name, shape, dtype, causal in k3_cases:
        q, k, v = k3_inputs(shape, dtype, gen, dev)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, mean_err, used = k3_err(got, want, v, causal, name)
        errs["K3"] = max(errs["K3"], err)
        report["k3_errors"].append([name, shape, str(dtype)[6:], causal, err, mean_err, used])
        log(f"[K3] {name} {shape} {str(dtype)[6:]} causal={causal}: max abs err {err:.3g}, "
            f"mean {mean_err:.3g}, {used:.3f} of the tolerance")
    gshape = (4, SEQ_WINDOW - 1, 4, 32)
    q, k, v = (x.detach().requires_grad_() for x in k3_inputs(gshape, torch.float32, gen, dev))
    g_out = torch.randn(gshape, generator=gen, device=dev)
    grads = torch.autograd.grad(FA.flash_attention(q, k, v), (q, k, v), g_out)
    plain_grads = torch.autograd.grad(FA.flash_attention_plain(q, k, v), (q, k, v), g_out)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(grads, plain_grads))
    require(all(torch.allclose(a, b, rtol=2e-3, atol=2e-3) for a, b in zip(grads, plain_grads)),
            f"K3 gradients vs autograd through the plain version: max abs err {grad_err}")
    log(f"[K3] gradients {gshape} f32 vs autograd through the plain version: "
        f"max abs err {grad_err:.3g} (tolerance 2e-3)")

    # -- 7. the anomaly plane: harvest ticks of the three scorer families -------
    stream = ContainerStream(args.seed + 3, vocab=512, dim=4096, window=SEQ_WINDOW)
    data = [stream.tick() for _ in range(TICKS)]
    seq_cfg = M.SeqConfig(vocab=512)  # the operator's at entropy-log2-width 12 (tpusketch.py:622)
    families = {  # tpusketch.py:617, :625
        "ae": lambda d: M.ae_init(M.AEConfig(input_dim=4096, hidden_dim=256, latent_dim=64),
                                  seed=args.seed, device=d),
        "vae": lambda d: M.vae_init(M.VAEConfig(input_dim=4096, hidden_dim=256, latent_dim=64),
                                    seed=args.seed, device=d),
        "seq": lambda d: M.seq_init(seq_cfg, seed=args.seed, device=d),
    }
    mat, n_ready, count_mat = data[-1]
    log(f"[anomaly] {TICKS} ticks of {CONTAINERS * 64} events over {len(stream.counts)} "
        f"containers: seq matrix {mat.shape} with {n_ready} ready rows, "
        f"{int((mat[:n_ready] < 0).any(axis=1).sum())} of them short; counts {count_mat.shape}")
    ticks: dict = {}
    for fam, init in families.items():
        batches = [d[0] for d in data] if fam == "seq" else [d[2] for d in data]
        scorer = init(dev)
        noise_state = scorer.gen.get_state() if fam == "vae" else None
        reset_launches()
        losses, scores, secs = run_ticks(scorer, batches, "flash")
        launched = read_launches()
        want_k3 = seq_cfg.n_layers * 2 * TICKS if fam == "seq" else 0  # train forward + score
        require(launched == {"K1": 0, "K2": 0, "K3": want_k3},
                f"{fam} ticks launched {launched}, expected K3 {want_k3} and no K1, K2")
        for (m_i, r_i, c_i), sc in zip(data, scores):
            rows = m_i.shape[0] if fam == "seq" else c_i.shape[0]
            require(sc.shape == (rows,) and np.isfinite(sc).all(), f"{fam} scores {sc.shape}")
            if fam == "seq":
                require((sc[:r_i] > 0).all() and (sc[r_i:] == 0).all(),
                        "seq: ready rows score > 0, filler rows 0")
        noise = None
        if noise_state is not None:  # the CPU takes the card's draws
            replay = torch.Generator(device=dev)
            replay.set_state(noise_state)
            noise = [torch.randn(b.shape[0], 64, generator=replay, device=dev).cpu()
                     for b in batches]
        cpu_losses, cpu_scores, cpu_secs = run_ticks(init("cpu"), batches, "flash", noise)
        vs_cpu = max(float(np.abs(a - b).max()) for a, b in zip(scores, cpu_scores))
        rel_cpu = max(float((np.abs(a - b) / np.abs(b).clip(min=1e-6)).max())
                      for a, b in zip(scores, cpu_scores))
        entry = {"losses": losses, "cpu_losses": cpu_losses, "tick_s": secs,
                 "cpu_tick_s": cpu_secs, "launches": launched, "max_abs_vs_cpu": vs_cpu,
                 "max_rel_vs_cpu": rel_cpu, "first_scores": scores[0][:8].tolist(),
                 "last_scores": scores[-1][:8].tolist()}
        if fam == "seq":
            # bf16 activations, 8 AdamW steps: 0.05 nats (0.8% of ln 512) per container
            require(vs_cpu <= 0.05, f"seq scores, card vs CPU: max abs diff {vs_cpu}")
            reset_launches()
            _, full_scores, full_secs = run_ticks(init(dev), batches, "full")
            require(read_launches()["K3"] == 0, "attn='full' launched K3")
            vs_full = max(float(np.abs(a - b).max()) for a, b in zip(scores, full_scores))
            require(vs_full <= 0.05, f"seq scores, flash vs full on the card: max abs diff {vs_full}")
            entry.update(max_abs_vs_full=vs_full, full_tick_s=full_secs)
            log(f"[anomaly] seq: flash vs full on the card max abs diff {vs_full:.3g}, "
                f"card vs CPU {vs_cpu:.3g} (tolerance 0.05 nats)")
        else:
            # bf16 matmuls on two devices, 8 Adam steps: 5% of each score
            require(rel_cpu <= 5e-2, f"{fam} scores, card vs CPU: max rel diff {rel_cpu}")
            log(f"[anomaly] {fam}: card vs CPU max rel diff {rel_cpu:.3g} (tolerance 5e-2)")
        # the tick time: ticks 2-8 in all over 7 (the first is warm-up), so a
        # stall in any tick shows; the median only beside it
        entry["tick_ms"] = sum(secs[1:]) / (TICKS - 1) * 1e3
        entry["tick_ms_median"] = statistics.median(secs[1:]) * 1e3
        log(f"[anomaly] {fam}: loss {losses[0]:.5g} -> {losses[-1]:.5g}; tick "
            f"{entry['tick_ms']:.3f} ms over ticks 2-{TICKS} (median "
            f"{entry['tick_ms_median']:.3f}, first {secs[0] * 1e3:.2f}; CPU "
            f"{sum(cpu_secs[1:]) / (TICKS - 1) * 1e3:.1f} ms); launches {launched}")
        ticks[fam] = entry
    launches["K3"] = ticks["seq"]["launches"]["K3"] + par["launches"]["K3"]
    report["anomaly_ticks"] = ticks

    # -- per-kernel times at the main path's shapes -----------------------------
    times_end = time_kernels()
    log_times("the kernels at the script's end", times_end)
    report["kernel_times"]["end"] = times_end
    (k1_ms, k1_plain, k1_lib), (k2_ms, k2_plain, k2_lib), (k3_ms, k3_plain, k3_lib) = (
        times_end[name] for name in ("K1", "K2", "K3"))
    geom = bundle.geometry()
    ent_lw = prod["entropy_log2_width"]
    k3_bound_ms, k3_bound_by = k3_bound(op_shape, torch.bfloat16, True)
    q, k, v = k3_inputs(long_shape, torch.bfloat16, gen, dev)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    long_bound = k3_bound(long_shape, torch.bfloat16, True)
    # the harvest's entropy in the reference's float32 arithmetic (~200 small
    # torch ops): host clock over 20 calls ending in a synchronize
    from inspektor_gadget_tpu_torch.ops.entropy import entropy_estimate
    entropy_estimate(bundle.entropy)
    torch.cuda.synchronize()
    t_ent = time.perf_counter()
    for _ in range(20):
        entropy_estimate(bundle.entropy)
    torch.cuda.synchronize()
    report["entropy_estimate_ms"] = (time.perf_counter() - t_ent) / 20 * 1e3
    log(f"[time] the harvest's entropy estimate over {1 << ent_lw} buckets: "
        f"{report['entropy_estimate_ms']:.3f} ms a call (host clock)")
    report["k3_long_window"] = {
        "shape": long_shape, "ms": time_cuda(lambda: FA.flash_attention(q, k, v), per_round=2),
        "plain_ms": time_cuda(lambda: FA.flash_attention_plain(q, k, v), rounds=5, per_round=1,
                              warm=1),
        "library_ms": time_cuda(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                        is_causal=True)),
        "bound_ms": long_bound[0], "bound_by": long_bound[1]}
    log(f"[time] K3 long window {long_shape}: " + ", ".join(
        f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
        for key, val in report["k3_long_window"].items()))
    k1_bytes = batch * 4 * 2 + (1 << ent_lw) * 8  # int64 counts out
    k2_bytes = batch * 4 * 5 + geom.total * 4
    kernels = [
        {"name": "K1 hashed histogram (entropy update)", "route": "cuda", "source": SRC,
         "replaces": "inspektor_gadget_tpu/ops/pallas_kernels.py:61",
         "launches": launches["K1"], "max_abs_err": errs["K1"], "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": k1_lib},
        {"name": "K2 fused sketch planes", "route": "cuda", "source": SRC,
         "replaces": "inspektor_gadget_tpu/ops/pallas_kernels.py:296",
         "launches": launches["K2"], "max_abs_err": errs["K2"], "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": k2_lib},
        {"name": "K3 flash attention (seq scorer, causal, operator window)", "route": "cuda",
         "source": K3_SRC, "replaces": "inspektor_gadget_tpu/parallel/flash_attention.py:86",
         "launches": launches["K3"], "max_abs_err": errs["K3"], "ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_bound_ms, "bound_by": k3_bound_by,
         "library_ms": k3_lib},
    ]
    for kinfo in kernels:
        log(f"[time] {kinfo['name']}: {kinfo['ms']:.4f} ms, plain {kinfo['plain_ms']:.4f} ms, "
            f"bound {kinfo['bound_ms']:.5f} ms, library {kinfo['library_ms']:.4f} ms")
    report.update(kernels=kernels, e2e_ev_per_s=e2e_ev_s, device_ev_per_s=device_ev_s,
                  steps=total_steps, batch=batch, pool_hits=pool.hits,
                  pool_misses=pool.misses, heavy_hitters=[[int(k), int(c)] for k, c in
                                                          zip(keys[:16], counts[:16])],
                  distinct_estimate=distinct_est, distinct_exact=int(true_distinct),
                  max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))

    log(f"[device] {rep['nvidia_smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": rep["kind"],
                                             "count": rep["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
