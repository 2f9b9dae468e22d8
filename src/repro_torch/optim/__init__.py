from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, OptState, adamw_init, adamw_update, global_norm, opt_state_defs,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
