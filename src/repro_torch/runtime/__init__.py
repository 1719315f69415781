"""Graph IR, batch-fused graph executor, packing, schedule cache and
execution traces."""
