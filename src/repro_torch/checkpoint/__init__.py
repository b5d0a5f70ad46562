from repro_torch.checkpoint.ckpt import (latest_step,  # noqa: F401
                                         restore_checkpoint, save_checkpoint)
