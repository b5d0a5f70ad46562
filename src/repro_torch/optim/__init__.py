from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm)
from repro_torch.optim.lowbit import q8_decode, q8_encode  # noqa: F401
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         linear_warmup, wsd_schedule)
