"""Perf plane: the stage-segmented harness, provenance-stamped
PerfRecords, the append-only ledger and noise-aware regression
comparison (the port's copy of ``inspektor_gadget_tpu/perf``).

Surfaces: `ig-tpu-torch bench run|compare|report|import` (`cli/bench.py`)
and the bench modules' `python -m inspektor_gadget_tpu_torch.perf.<name>`.
"""

from .compare import (
    CompareResult,
    compare_ledger,
    compare_record,
    render_compare,
    render_report,
)
from .harness import HARNESS_CONFIGS, run_harness
from .ledger import (
    DEFAULT_LEDGER,
    append_record,
    bench_json_to_record,
    import_bench_files,
    ledger_path,
    read_ledger,
)
from .provenance import build_provenance, probe_block
from .schema import SCHEMA_ID, STAGES, make_record, validate_record

__all__ = [
    "CompareResult", "DEFAULT_LEDGER", "HARNESS_CONFIGS", "SCHEMA_ID",
    "STAGES", "append_record", "bench_json_to_record", "build_provenance",
    "compare_ledger", "compare_record", "import_bench_files", "ledger_path",
    "make_record", "probe_block", "read_ledger", "render_compare",
    "render_report", "run_harness", "validate_record",
]
