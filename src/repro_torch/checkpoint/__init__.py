from repro_torch.checkpoint.store import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
