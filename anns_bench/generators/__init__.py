"""Data generators, one module a generator: ``generators/<name>.py``, found
by the configuration's ``dataset.generator`` key (``data.generate``). Each
holds ``generate(spec, seed, device) -> {"base", "train", "query"}``: float32
host arrays drawn from the dataset block ``spec`` and the run's seed, the
same for the same seeds. Nothing here imports the program.
"""
