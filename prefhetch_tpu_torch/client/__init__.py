"""Client side of the protocol (host, numpy): the port of prefhetch_tpu/client."""
