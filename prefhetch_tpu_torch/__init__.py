"""prefhetch_tpu_torch — the PyTorch/CUDA port of prefhetch_tpu for Hopper.

A second package beside the JAX one (``prefhetch_tpu``), which stays the
reference: every module here has the same name as its JAX counterpart, so a
reader finds each pair, and the tests hold each against the other on the same
inputs. Plain tensor code is PyTorch; every Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper under ``csrc/``.

Everything the JAX package does is ported (the fused triage search, the
BFV encrypted re-rank with its packed wire and whole result ciphertexts,
CKKS slot-packed encrypted scoring, private row retrieval, the scan
variants, serving over HTTP and sharding), each end to end:

- ``data``     — fvecs/ivecs IO (the native reader) and the synthetic
                 SIFT-style generator
- ``index``    — ``IVFIndex`` dataclass, k-means/PQ build, npz save/load,
                 the tiled serving views
- ``ops``      — distances, top-k, the union scan with its CUDA kernel
                 (``ops/union_scan_min.py``), exact re-rank, k-means; the
                 four-step NTT (``ops/ntt4.py``) with its CUDA kernel, one
                 launch per transform (``ops/ntt4_fused.py``); the PQ, SQ8
                 and slab scans with theirs
- ``crypto``   — host-side RNS-BFV, RNS-CKKS and PIR, the host NTT (native,
                 with the numpy butterfly as its oracle), packing, RNG
- ``client``   — ``HEClient``; the reference's client stages
                 (``client/pipeline.py``), the binary-wire client and the CLI
- ``engine``   — ``QueryEngine`` (the reference's four services, the tiled
                 and top-k coarse wires, fused search, encrypted re-rank),
                 ``HEComputeService`` (BFV), ``DeviceCKKS`` and its numpy
                 twin ``CKKSComputeService`` (CKKS), ``DevicePIR2`` (PIR)
- ``serve``    — ``Dispatcher`` (every route), the batcher, the threaded,
                 asyncio and native epoll frontends, and
                 ``python -m prefhetch_tpu_torch.serve.main``
- ``parallel`` — meshes of shards, the sharded services and
                 ``torch.distributed`` worlds
- ``native``   — the host C++ libraries (vecs reader and host NTT, JSON
                 codec, epoll frontend), built with g++ at first use
- ``utils``    — config presets, wire codecs, timers, the nvcc build helper

Importing this package has no side effects: it imports no JAX, touches no
device and builds nothing. Entry points take ``device=`` (default
``"cuda"``) and raise when CUDA is missing unless the caller asks for
``device="cpu"`` (``device.resolve_device``).
"""

__version__ = "0.1.0"
