"""The search service of the port: DSL, lowering, the GPU serving path."""
