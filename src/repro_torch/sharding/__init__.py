"""Sharding rules over the (pod, data, model) production mesh, on
``DTensor``."""
from .rules import (batch_spec, cache_sharding, param_sharding,
                    state_sharding, logical_to_physical)

__all__ = ["param_sharding", "cache_sharding", "batch_spec",
           "state_sharding", "logical_to_physical"]
