"""top/* gadgets — interval heavy-hitter views (ref: pkg/gadgets/top/*)."""
