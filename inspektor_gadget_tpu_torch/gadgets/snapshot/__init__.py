"""snapshot/* gadgets — one-shot state collectors (ref: pkg/gadgets/snapshot): the port's
``snapshot process`` and ``snapshot socket``."""
