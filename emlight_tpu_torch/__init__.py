"""emlight_tpu_torch — the PyTorch/CUDA port of emlight_tpu for NVIDIA Hopper.

Same structure and names as ``emlight_tpu``, so every function has an obvious
counterpart there; the JAX package is the reference the port is tested
against. This package imports torch, numpy and the standard library only —
never jax, flax, optax or any ``emlight_tpu`` module.

- ``cli``             the inference CLIs ``infer`` and ``test_regression``
- ``config``          frozen dataclass config tree (same defaults)
- ``core``            sphere geometry, EXR/PIZ codec and HDR image handling,
                      msgpack codec and PNG writer (own copies or stdlib
                      versions), device selection
- ``nn``              sphere conv and the dense layer's fused affine 3x3 conv
                      (plain versions, autograd Functions, CUDA kernel
                      wrappers), SPADE generator, discriminator, DenseNet-BC
                      regressor
- ``losses``          GAN objectives and the Sinkhorn anchor loss
- ``kernels``         builds ``csrc/*.cu`` with nvcc for sm_90a and loads it
                      through ctypes, at first use
- ``representation``  Gaussian-splat rasterizer
- ``train``           entry points: serving (regression predict, generator
                      inference, the fused crop -> HDR env map pipeline), GAN
                      and regression training steps, synthetic batches, the
                      weight bridge to and from JAX parameter trees, JAX
                      checkpoint read/write and reference .pth import

Public functions keep the JAX layout: images are NHWC ``(B, H, W, C)``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
