"""Host-side homomorphic encryption (numpy only): RNS-BFV keygen, encrypt,
decrypt, the butterfly NTT oracle, packing and the RNG contract — the port's
copies of prefhetch_tpu/crypto. Importing it sets no process-wide state."""
