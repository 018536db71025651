"""Attention of the sequence plane: `flash_attention` (K3) and the
single-device streaming and materialised versions in `ring_attention`."""
