from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm)
from .schedule import inverse_sqrt, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "warmup_cosine",
           "inverse_sqrt"]
