"""prefhetch_tpu_torch — the PyTorch/CUDA port of prefhetch_tpu for Hopper.

A second package beside the JAX one (``prefhetch_tpu``), which stays the
reference: every module here has the same name as its JAX counterpart, so a
reader finds each pair, and the tests hold each against the other on the same
inputs. Plain tensor code is PyTorch; every Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper under ``csrc/``.

Ported so far (the fused triage search, end to end):

- ``data``     — fvecs/ivecs IO and the synthetic SIFT-style generator (copies)
- ``index``    — ``IVFIndex`` dataclass, k-means/PQ build, npz save/load,
                 the tiled serving view
- ``ops``      — distances, top-k, the union scan with its CUDA kernel
                 (``ops/union_scan_min.py``), exact re-rank, k-means
- ``engine``   — ``QueryEngine``, plaintext fused search
- ``serve``    — ``Dispatcher`` subset (``/query``, ``/healthz``, ``/stats``,
                 binary ``/search``)
- ``utils``    — config presets, binary wire codec, the nvcc build helper

Importing this package has no side effects: it imports no JAX, touches no
device and builds nothing. Entry points take ``device=`` (default
``"cuda"``) and raise when CUDA is missing unless the caller asks for
``device="cpu"`` (``device.resolve_device``).
"""

__version__ = "0.1.0"
