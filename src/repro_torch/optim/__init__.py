"""Optimizer substrate of the port: AdamW and its LR schedules (the JAX
package's ``repro.optim`` on one device; ZeRO moment sharding and
gradient compression need a mesh and wait for ROADMAP A, item 4b)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     decay_mask, global_norm, init_adamw)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "decay_mask",
           "global_norm", "init_adamw", "constant", "warmup_cosine"]
