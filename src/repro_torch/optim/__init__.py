from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     clip_by_global_norm, cosine_lr,
                                     global_norm, init_opt_state)
from repro_torch.optim.compression import (dequantize, init_error_state,
                                           quantize)
