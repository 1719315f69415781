"""Graph IR, graph executor (batch_fused / batched / per_tile), the
tile-pipeline executor ``dcn_pipeline``, packing, schedule cache and
execution traces."""
