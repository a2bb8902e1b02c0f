"""skypilot_torch — the PyTorch/CUDA port of the skypilot_tpu compute
library, for NVIDIA Hopper (sm_90a).

The JAX package ``skypilot_tpu`` stays the reference: every module here
mirrors its counterpart's name and public layouts, and the parity
tests (``tests/test_torch_*.py``) feed both the same weights and
inputs. This package imports ``torch``, numpy and the standard library
only — never ``jax`` and nothing from ``skypilot_tpu``.

Device rule: entry points take an explicit ``device`` and default to
``'cuda'``; where CUDA is absent they raise (``device.DeviceError``)
instead of quietly running on the CPU. On a CUDA tensor each op
launches its hand-written kernel (``csrc/``) or raises; the plain
PyTorch version of each kernel runs only for tensors on the CPU.
"""

__version__ = '0.1.0'
