"""Host-side homomorphic encryption (numpy, and the native host NTT):
RNS-BFV and RNS-CKKS keygen, encrypt, decrypt and Galois keys, the NTT
with its butterfly oracle, packing and the RNG contract — the port's
copies of prefhetch_tpu/crypto. Importing it sets no process-wide state."""
