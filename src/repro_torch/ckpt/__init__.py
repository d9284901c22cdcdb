from repro_torch.ckpt.checkpoint import (host_state, latest_checkpoint,
                                         load_checkpoint,
                                         load_sharded_checkpoint,
                                         save_checkpoint,
                                         save_sharded_checkpoint)
