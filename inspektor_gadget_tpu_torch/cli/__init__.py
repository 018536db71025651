"""CLI frontend (ref: cmd/ig, cmd/common/registry.go — the command tree is
generated from the gadget registry/catalog, flags from ParamDescs): the
port's ``ig-tpu-torch`` (`cli.main`)."""
