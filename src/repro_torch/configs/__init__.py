"""Architecture registry: `get_config(name)` / `list_configs()` expose the
10 assigned architectures.

The port's own copy of the JAX package's ``repro.configs`` (pure data, no
JAX): the same `ModelConfig` fields, registry names and `reduced_config`,
so ``dataclasses.asdict`` of every config equals the reference's."""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, ALL_SHAPES,
                                      SHAPES, TRAIN_4K, PREFILL_32K,
                                      DECODE_32K, LONG_500K, get_config,
                                      list_configs, reduced_config, register)

__all__ = ["ModelConfig", "ShapeConfig", "ALL_SHAPES", "SHAPES",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "get_config", "list_configs", "reduced_config", "register"]
