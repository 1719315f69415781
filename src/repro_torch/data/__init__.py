from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                       host_slice, image_batch, token_batch)
