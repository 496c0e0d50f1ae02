"""emlight_tpu_torch — the PyTorch/CUDA port of emlight_tpu for NVIDIA Hopper.

Same structure and names as ``emlight_tpu``, so every function has an obvious
counterpart there; the JAX package is the reference the port is tested
against. This package imports torch, numpy, scipy (the needlet basis's
window quadrature and log-gamma) and the standard library only — never jax,
flax, optax or any ``emlight_tpu`` module.

- ``cli``             the CLIs: inference (``infer``, ``test_regression``,
                      ``test_projector``), training (``train_regression``,
                      ``train_projector``), evaluation (``eval_metrics``,
                      ``eval_projector``), GT (``extract_distribution``,
                      ``needlets_gt``), ``fit_single``, ``verify_parity``,
                      ``sphere_demo``, ``preview``, ``modify_pickles``
- ``config``          frozen dataclass config tree (same defaults)
- ``core``            sphere geometry, EXR/PIZ codec and HDR image handling,
                      msgpack codec and PNG writer (own copies or stdlib
                      versions), device selection
- ``nn``              sphere conv and the dense layer's fused affine 3x3 conv
                      (plain versions, autograd Functions, CUDA kernel
                      wrappers), sphere max pool, SPADE generator,
                      discriminator, DenseNet-BC regressor, VGG19, the
                      OmniMNIST sphere projection (``sphere_demo``)
- ``losses``          GAN objectives, the Sinkhorn anchor loss and the
                      image-grid Sinkhorn (``image_ot``)
- ``needlets``        spherical harmonics, HEALPix, the needlet basis and
                      the needlet GT pipeline (project, sparsify,
                      reconstruct on the device)
- ``kernels``         builds ``csrc/*.cu`` with nvcc for sm_90a and loads it
                      through ctypes, at first use
- ``native``          the EXR reader and writer in C++ (g++ at first use,
                      ctypes), which ``core/hdr.py`` reads ``.exr`` through
- ``representation``  Gaussian-splat rasterizer, anchor GT extraction,
                      spherical-Gaussian fitting (``fit``)
- ``train``           entry points: serving (regression predict, generator
                      inference, the fused crop -> HDR env map pipeline), GAN
                      and regression training steps, the datasets and
                      loaders (and synthetic batches), the loop services,
                      the weight and optimizer bridge to and from JAX trees,
                      train-state checkpoints in the JAX package's format,
                      reference .pth import (regressor, generator,
                      discriminator) and the torch oracle of the reference
                      models (``torch_ref``)

Public functions keep the JAX layout: images are NHWC ``(B, H, W, C)``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
