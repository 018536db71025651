"""Integration-test step framework.

Python analogue of the reference's cluster-integration tier
(integration/teststeps.go:26-113, integration/command.go, and the JSON
expectation helpers in integration/helpers.go:31-176): tests are lists of
steps — subprocess commands, workload generators, cleanup steps — run in
order with start-and-stop semantics, guaranteed cleanup, and declarative
output matching against normalized JSON events.

The port's copy of ``inspektor_gadget_tpu/testing/__init__.py``, its chaos
tools (`AgentProcess`, `ChaosProxy`, `SkewClock`) included.
"""

from .chaos import AgentProcess, ChaosProxy, SkewClock
from .match import (
    build_common_data,
    expect_all_entries_to_match,
    expect_entries_in_array_to_match,
    expect_entries_to_match,
    parse_json_array,
    parse_multi_json,
)
from .steps import Command, FuncStep, TestStep, run_test_steps

__all__ = [
    "AgentProcess",
    "ChaosProxy",
    "SkewClock",
    "Command",
    "FuncStep",
    "TestStep",
    "run_test_steps",
    "build_common_data",
    "expect_all_entries_to_match",
    "expect_entries_in_array_to_match",
    "expect_entries_to_match",
    "parse_json_array",
    "parse_multi_json",
]
