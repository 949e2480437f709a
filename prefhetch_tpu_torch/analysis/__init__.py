"""Offline analyses of the protocol's privacy/quality trade-offs.

Not on any serving path — these quantify properties the protocol docs
claim (coarse-query leakage, quantization loss) with measured numbers.
"""

from prefhetch_tpu_torch.analysis.coarse_leakage import (  # noqa: F401
    CoarseLeakageReport,
    measure_coarse_leakage,
)
