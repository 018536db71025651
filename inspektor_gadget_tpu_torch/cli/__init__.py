"""CLI frontend (ref: cmd/ig, cmd/common/registry.go — the command tree is
generated from the gadget registry/catalog, flags from ParamDescs): the
port's ``ig-tpu-torch`` (`cli.main`)."""

import sys


def unported(what: str, item: str) -> int:
    """Exit 2 naming the ROADMAP item that ports `what`."""
    print(f"error: {what} is not ported to ig-tpu-torch yet (ROADMAP item {item})",
          file=sys.stderr)
    return 2
