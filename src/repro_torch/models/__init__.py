"""Model primitives and the paged attention-stack forward."""
