"""Dataset IO and synthetic SIFT-style datasets (copies of prefhetch_tpu.data)."""
