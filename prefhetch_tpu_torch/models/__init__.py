from prefhetch_tpu_torch.models.flat import FlatL2  # noqa: F401
from prefhetch_tpu_torch.models.ivf import (  # noqa: F401
    IVFFlat, IVFPQ, IVFSQ8, rerank_exact,
)
