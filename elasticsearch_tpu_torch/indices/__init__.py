"""Index-level helpers: shard routing."""
