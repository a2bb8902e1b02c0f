"""Multi-tenant LoRA multiplexing — the port of
``skypilot_tpu/serve/adapters/``: one base model plus per-tenant q/v
adapters sharing one batched engine.

- :mod:`registry` — adapter id -> checkpoint lineage dir, manifest-
  validated (rank, target modules) and content-hash versioned (a copy,
  reading through ``skypilot_torch/checkpoint``);
- :mod:`resident` — the device-resident set: adapters stacked into
  ``[L, capacity+1, ...]`` f32 buffers (slot 0 = the all-zeros "no
  adapter" identity), LRU-evicted with refcount pinning, async cold
  loads installed in place between dispatches.

The per-row gather (each batch row picking its adapter's factors by
slot index inside the device step) is ``models/decode.lora_gather_delta``.
"""
from skypilot_torch.serve.adapters.registry import (AdapterRegistry,
                                                    AdapterSpec)
from skypilot_torch.serve.adapters.resident import ResidentAdapterSet

__all__ = ['AdapterRegistry', 'AdapterSpec', 'ResidentAdapterSet']
