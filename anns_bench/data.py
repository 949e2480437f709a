"""A configuration's data: drawn by the generator its dataset block's
``generator`` key names (``generators/<name>.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from anns_bench.cell import load
from anns_bench.generators.sift_style import (  # noqa: F401
    generate as make_sift_style,
)


def generate(spec: dict, seed: int,
             device: torch.device) -> Dict[str, np.ndarray]:
    """{"base", "train", "query"} of the dataset block ``spec`` and the
    run's seed."""
    return load("generators", spec["generator"]).generate(spec, seed, device)
