"""emlight_tpu_torch — the PyTorch/CUDA port of emlight_tpu for NVIDIA Hopper.

Same structure and names as ``emlight_tpu``, so every function has an obvious
counterpart there; the JAX package is the reference the port is tested
against. This package imports torch, numpy and the standard library only —
never jax, flax, optax or any ``emlight_tpu`` module.

- ``config``          frozen dataclass config tree (same defaults)
- ``core``            sphere geometry (own copy) and device selection
- ``nn``              sphere conv (plain version + CUDA kernel wrapper), SPADE
                      generator, DenseNet-BC regressor
- ``kernels``         builds ``csrc/*.cu`` with nvcc for sm_90a and loads it
                      through ctypes, at first use
- ``representation``  Gaussian-splat rasterizer
- ``train``           eval entry points (regression predict, generator
                      inference, the fused crop -> HDR env map pipeline) and
                      the weight bridge from JAX parameter trees

Public functions keep the JAX layout: images are NHWC ``(B, H, W, C)``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
