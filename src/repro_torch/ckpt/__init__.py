from repro_torch.ckpt.checkpoint import (host_state, latest_checkpoint,
                                         load_checkpoint, save_checkpoint)
