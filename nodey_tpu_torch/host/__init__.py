"""Host-side I/O: decode and encode (the codecs run on the CPU)."""
