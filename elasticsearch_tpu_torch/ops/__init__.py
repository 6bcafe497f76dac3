"""Device functions of the port: the merge kernel, its plain torch
version, and the host-side helpers that build their operands."""
