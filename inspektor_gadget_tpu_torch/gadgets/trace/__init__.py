"""trace/* gadgets — streaming event gadgets (ref: pkg/gadgets/trace/*)."""
