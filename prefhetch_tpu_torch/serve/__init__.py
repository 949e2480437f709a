"""Transport-agnostic route dispatch."""
