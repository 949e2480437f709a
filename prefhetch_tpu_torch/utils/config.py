"""Runtime configuration for the search pipeline.

The reference hardcodes every parameter as compile-time ``constexpr`` globals
(reference: include/common/client_server_utils.h:10-20) so that changing any
of them requires recompiling both binaries, and several are baked into the
wire format via fixed-size std::array JSON shapes. Here configuration is a
runtime dataclass; the reference operating point ships as the default preset
so behavior is comparable 1:1.

Copy of prefhetch_tpu/utils/config.py: artifact_name() must stay identical,
because both packages read each other's index files.

Reference operating point (include/common/client_server_utils.h:8-20):
    PRECISE_VECTOR_DIMENSIONS=128, NPROBE=20, COARSE_PROBE=200, K=100,
    NBASE=10000, NQUERY=5, NLIST=256, SUB_QUANTIZERS=32, SUB_QUANTIZER_SIZE=8
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Geometry of the server-side IVF(-PQ) index.

    Mirrors the constructor arguments of the reference's
    faiss::IndexIVFPQ(quantizer, d, nlist, M, nbits)
    (reference: src/server/server_lib.cpp:33-36).
    """

    d: int = 128                # PRECISE_VECTOR_DIMENSIONS
    nlist: int = 256            # NLIST — number of coarse centroids / inverted lists
    pq_m: int = 32              # SUB_QUANTIZERS — PQ sub-quantizer count (0 => IVF-Flat)
    pq_nbits: int = 8           # SUB_QUANTIZER_SIZE — bits per PQ code
    by_residual: bool = True    # FAISS IndexIVFPQ default: PQ encodes x - centroid
    metric: str = "l2"          # "l2" or "cosine" (angular — normalized L2)
    quantizer: str = "auto"     # "auto" (pq if pq_m>0 else flat) | "sq8"
    # Capacity-bounded assignment: list sizes ≤ balance·(nbase/nlist).
    # 0 = off (pure Voronoi, FAISS parity). ~1.25 kills the padded-layout
    # HBM waste on the device scan (index/build.assign_to_lists_balanced).
    balance: float = 0.0

    # Training knobs (FAISS Clustering defaults: 25 iterations, seed 1234).
    kmeans_iters: int = 25
    pq_kmeans_iters: int = 25
    seed: int = 1234

    @property
    def ksub(self) -> int:
        """Codewords per sub-quantizer."""
        return 1 << self.pq_nbits

    @property
    def dsub(self) -> int:
        """Dimensions per PQ subspace."""
        if self.pq_m == 0:
            return self.d
        assert self.d % self.pq_m == 0, "d must divide evenly into pq_m subspaces"
        return self.d // self.pq_m

    @property
    def uses_pq(self) -> bool:
        return self.pq_m > 0 and self.quantizer != "sq8"

    @property
    def uses_sq8(self) -> bool:
        return self.quantizer == "sq8"

    def artifact_name(self) -> str:
        """Parameter-encoding artifact filename.

        Parity with the reference's index cache naming
        ``NBASE…_IVF…_PQ…_SUB_QUANTIZER_SIZE….faiss``
        (reference: src/server/server_lib.cpp:38-42).
        """
        if self.uses_sq8:
            kind = "SQ8"
        elif self.uses_pq:
            kind = f"PQ{self.pq_m}_NBITS{self.pq_nbits}"
        else:
            kind = "FLAT"
        metric = "" if self.metric == "l2" else f"_{self.metric.upper()}"
        bal = "" if self.balance <= 0 else f"_BAL{self.balance:g}"
        return f"D{self.d}_IVF{self.nlist}_{kind}{metric}{bal}.npz"


@dataclasses.dataclass(frozen=True)
class HEParams:
    """Homomorphic-encryption layer parameters (the reference's SEAL slot,
        CMakeLists.txt:33-38, realized in crypto/, engine/hecompute.py and
    engine/ckks_device.py: BFV with the "full", "q1" and "packed"
    responses, CKKS with the per-block and "combined" ones).

    scheme: "bfv" (exact integer) or "ckks" (approximate, slot-packed).
    n / t_bits / n_limbs follow BASELINE.json config 2 defaults
    (N=4096, 2 RNS limbs; t=2^24 holds SIFT inner products exactly).
    """

    scheme: str = "bfv"
    n: int = 4096
    t_bits: int = 24       # BFV plaintext modulus bits
    n_limbs: int = 2
    scale_bits: int = 26   # CKKS fixed-point scale (config 3: N=8192)
    # PIR plaintext modulus: small (keeps the Σ-of-G-MACs noise within
    # budget), > 255 (byte-valued rows), and ODD so the 2^logm factor from
    # oblivious query expansion is invertible mod t. 257 is prime.
    pir_plain_modulus: int = 257
    # Sparse ternary secret hamming weight (None = dense ternary). Required
    # ≤ ~62 by the modulus-switched response wire (resp_mod="q1"): the
    # mod-down rounding error (1+h)/2 must stay under q1/(2t) ≈ 32.
    sparse_h: Optional[int] = None
    # Encrypted-rerank response form: "full" = 2-limb truncated wire (BFV)
    # / per-block result cts (CKKS); "q1" = single-limb modulus-switched
    # BFV wire (~2× smaller download, needs sparse_h); "packed" = BFV
    # single-ct coefficient-extracted response (the client's Galois keys,
    # odd t: bfv_params_for(odd_t=True)); "combined" = CKKS
    # single-ct tree-combined response (~16× smaller download, needs the
    # −2^k combine-tree Galois keys). See engine/hecompute.py.
    resp_mod: str = "full"


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    """Fan-outs of the multi-round triage protocol.

    nprobe:       inverted lists probed per query (client-chosen; the server
                  never runs quantizer assignment — reference §2.3 contract,
                  src/server/server_lib.cpp:121,126-130).
    coarse_probe: candidates the client keeps after the coarse round
                  (reference: COARSE_PROBE=200).
    k:            final top-K results (reference: K=100).
    nquery:       batch size of the client driver (reference: NQUERY=5).
    """

    nprobe: int = 20
    coarse_probe: int = 200
    k: int = 100
    nquery: int = 5
    # When True, the precise re-rank round runs over an encrypted query
    # (client sends Enc(q); server returns Enc(⟨q,x⟩) + plaintext norms).
    encrypted_rerank: bool = False
    # "plain": reference-parity placeholder (cleartext indices, raw gather).
    # "he": real single-server PIR (crypto/pir.py) — the server never learns
    # which rows were fetched. Upload-heavy (G cts per row) until query
    # expansion lands; practical at small nbase / demo scale.
    pir_mode: str = "plain"

    def validate(self) -> None:
        if self.k > self.coarse_probe:
            # reference: src/client/client_lib.cpp guard "K greater than COARSE_PROBE"
            raise ValueError("K greater than COARSE_PROBE")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full configuration: index geometry + protocol fan-outs + dataset paths."""

    index: IndexParams = dataclasses.field(default_factory=IndexParams)
    protocol: ProtocolParams = dataclasses.field(default_factory=ProtocolParams)
    he: HEParams = dataclasses.field(default_factory=HEParams)

    nbase: int = 10000          # NBASE
    # Dataset file paths (reference hardcodes these relative to build/:
    # src/server/server_lib.cpp:22-27, src/client/client_lib.cpp:12-14).
    train_path: Optional[str] = None
    base_path: Optional[str] = None
    query_path: Optional[str] = None
    groundtruth_path: Optional[str] = None

    # Server address (reference: include/client/client_lib.h:7 hardcodes
    # http://localhost:8080/).
    host: str = "0.0.0.0"
    port: int = 8080

    def validate(self) -> None:
        """Cross-field checks run at engine/client start."""
        self.protocol.validate()
        if self.index.metric == "cosine" and (
            self.protocol.encrypted_rerank or self.protocol.pir_mode == "he"
        ):
            # the exact BFV paths need integer-valued data; unit-normalized
            # cosine vectors would silently round to garbage
            raise ValueError(
                "encrypted_rerank / pir_mode='he' require integer-valued "
                "vectors (e.g. SIFT bytes); metric='cosine' operates on "
                "unit-normalized floats — fixed-point quantize the dataset "
                "or use the plaintext protocol"
            )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "PipelineConfig":
        raw = json.loads(s)
        return PipelineConfig(
            index=IndexParams(**raw.pop("index")),
            protocol=ProtocolParams(**raw.pop("protocol")),
            he=HEParams(**raw.pop("he", {})),
            **raw,
        )


# The reference operating point: SIFT-small / SIFT10K
# (include/common/client_server_utils.h:8-20, dataset.sh:4-10).
REFERENCE_PRESET = PipelineConfig()

# The north-star operating point: SIFT1M IVF triage
# (BASELINE.json configs[0]: nlist=1024, nprobe=16).
SIFT1M_PRESET = PipelineConfig(
    index=IndexParams(d=128, nlist=1024, pq_m=32, pq_nbits=8),
    protocol=ProtocolParams(nprobe=16, coarse_probe=256, k=100, nquery=64),
    nbase=1_000_000,
)
