"""Dataclass config tree — same fields and defaults as emlight_tpu/config.py.

Kept as an own copy (the port imports nothing of the JAX package). Only the
configs the port's entry points read are here; NeedletsConfig waits for the
needlets port.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class AnchorConfig:
    n_anchors: int = 128          # GT extraction + GenProjector
    regression_anchors: int = 96  # regression head/loss width
    env_h: int = 128
    env_w: int = 256
    splat_size: float = 0.0025
    light_threshold: float = 0.05
    intensity_scale: float = 500.0


@dataclass(frozen=True)
class SinkhornConfig:
    p: float = 2.0
    blur: float = 0.025
    scaling: float = 0.5
    value_weight: float = 0.1
    n_iters: int = 12
    diameter: float | None = None
    backend: str = "auto"


@dataclass(frozen=True)
class RegressionConfig:
    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    sinkhorn: SinkhornConfig = field(default_factory=SinkhornConfig)
    crop_h: int = 192             # 4:3 crop -> 8208-dim pooled features
    crop_w: int = 256
    block_config: tuple[int, ...] = (16, 16, 16)
    growth_rate: int = 12
    num_init_features: int = 24
    batch_size: int = 16
    lr: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.999)
    w_emd: float = 1000.0
    w_dist_l2: float = 1000.0
    w_intensity: float = 0.1
    w_rgb: float = 100.0
    w_ambient: float = 1.0
    dtype: str = "float32"
    remat: bool = False
    clip_grad_norm: float = 0.0
    log_grad_norms: bool = False
    train_forward: str = "buffer"


@dataclass(frozen=True)
class ProjectorConfig:
    """SPADE GenProjector (GenProjector/options + train_laval.sh defaults)."""

    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    crop_size: int = 256          # env map = (crop_size/2, crop_size)
    ngf: int = 64
    ndf: int = 64
    num_d: int = 2
    n_layers_d: int = 4
    semantic_nc: int = 3
    output_nc: int = 3
    batch_size: int = 16
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.9
    gan_mode: str = "hinge"
    lambda_vgg: float = 5.0
    lambda_cos: float = 5.0
    use_vae: bool = False
    lambda_kld: float = 0.05
    ambient_feat_weight: float = 50.0
    num_upsampling_layers: str = "normal"
    norm_g: str = "spectralspadesyncbatch3x3"
    use_vgg_loss: bool = True
    d_steps_per_g: int = 1
    # "bfloat16": sphere convs and SNConv compute in bf16 with f32
    # accumulation; params, norms and everything else stay f32
    dtype: str = "float32"
    niter: int = 100
    niter_decay: int = 100
    clip_grad_norm: float = 0.0
