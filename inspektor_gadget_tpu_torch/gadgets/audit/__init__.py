"""audit/* gadgets (ref: pkg/gadgets/audit)."""
