"""Host-side building blocks the node runs on: errors, settings and the
circuit breakers."""
