"""Host scene types, device packing, golden-scene construction."""
