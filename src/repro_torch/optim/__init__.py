from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     init_adamw)
from repro_torch.optim.schedule import lr_at

__all__ = ["AdamWState", "adamw_update", "clip_by_global_norm",
           "global_norm", "init_adamw", "lr_at"]
