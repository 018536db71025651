"""advise/* gadgets — record-then-synthesize policy generators
(ref: pkg/gadgets/advise + pkg/gadget-collection/gadgets/advise, the legacy
CRD-path gadgets driven by start/stop/generate operations)."""
