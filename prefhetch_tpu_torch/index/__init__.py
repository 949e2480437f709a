"""IVF(-PQ) index: storage dataclass, build, save/load, tiled serving view."""
