"""Test helper: each package's gadget registry pinned to its own gadgets.

The reference's and the port's registries share a test process with
every other test file, and some register gadgets for good:
tests/test_aux.py imports examples/custom_gadget.py, which registers
trace/heartbeat in the reference's registry. A test that compares the
two packages' catalogs or gadget reports runs inside
`own_gadgets_only()`, which takes such gadgets out for its duration and
puts them back after.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def own_gadgets_only():
    from inspektor_gadget_tpu.gadgets import registry as ref_registry
    from inspektor_gadget_tpu_torch.gadgets import registry as port_registry
    stashed = []
    for reg, pkg in ((ref_registry, "inspektor_gadget_tpu."),
                     (port_registry, "inspektor_gadget_tpu_torch.")):
        other = {k: d for k, d in reg._REGISTRY.items() if not type(d).__module__.startswith(pkg)}
        for k in other:
            del reg._REGISTRY[k]
        stashed.append((reg, other))
    try:
        yield
    finally:
        for reg, other in stashed:
            reg._REGISTRY.update(other)
