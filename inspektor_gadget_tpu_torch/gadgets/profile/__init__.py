"""profile/* gadgets — sampling profilers with run-with-result semantics
(ref: pkg/gadgets/profile/*)."""
