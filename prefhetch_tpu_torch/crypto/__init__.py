"""Host-side homomorphic encryption (numpy only): RNS-BFV and RNS-CKKS
keygen, encrypt, decrypt and Galois keys, the butterfly NTT oracle, packing
and the RNG contract — the port's copies of prefhetch_tpu/crypto. Importing
it sets no process-wide state."""
