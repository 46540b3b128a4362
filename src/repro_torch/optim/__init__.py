"""Optimizer substrate of the port: AdamW (with ZeRO-1 sharded moments on
a mesh), its LR schedules, and int8 gradient compression (the JAX
package's ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     adamw_update_sharded, decay_mask,
                                     global_norm, init_adamw,
                                     sharded_global_norm, zero_specs)
from repro_torch.optim.compression import (CompressionState, compress,
                                           compressed_psum, decompress,
                                           init_compression)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "AdamWState", "adamw_update",
           "adamw_update_sharded", "decay_mask", "global_norm",
           "init_adamw", "sharded_global_norm", "zero_specs", "constant",
           "warmup_cosine", "CompressionState", "compress",
           "compressed_psum", "decompress", "init_compression"]
