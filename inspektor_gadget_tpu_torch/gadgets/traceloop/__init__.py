"""traceloop — strace-of-the-past (ref: pkg/gadgets/traceloop)."""
