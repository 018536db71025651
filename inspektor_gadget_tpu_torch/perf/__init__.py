"""Provenance stamping of what produced a journal (`perf.provenance`)."""
