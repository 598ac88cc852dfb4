from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_schedule,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim import compress  # noqa: F401
