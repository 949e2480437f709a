"""Server-side query engine."""
