from repro_torch.checkpoint.store import (AsyncCheckpointer, completed_steps,
                                          latest_step, restore, save)
