from repro_torch.ckpt.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    gc_old,
    jax_layout,
    latest_step,
    load,
    restore,
    save,
    save_sharded,
)
