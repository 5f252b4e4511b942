"""Traffic: one module per kind, and the mixes (<name>.json) they read."""
