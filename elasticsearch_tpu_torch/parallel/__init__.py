"""Device placement and the stacked-shard search step."""
