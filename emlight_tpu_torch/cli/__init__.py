"""Command-line entry points of the port (``python -m emlight_tpu_torch.cli.<name>``).

- ``infer``            crop .exr -> HDR env map .exr + .png preview (+ pickles)
- ``test_regression``  crop .exr -> anchor-parameter pickles (+ _env.png)
- ``train_regression`` DenseNet anchor regressor training from a Laval-layout root
- ``train_projector``  SPADE GenProjector GAN training from a Laval-layout root
- ``test_projector``   GT pickles + crops -> HDR env map .exr + .png preview
- ``eval_projector``   a projector checkpoint's env and light-direction errors
- ``eval_metrics``     a regression checkpoint's parameter, env and direction errors
- ``extract_distribution`` warped panorama .exr -> anchor-GT pickles
- ``needlets_gt``      warped panorama .exr -> needlet coefficient .npy (jmax 2 or 3)
- ``fit_single``       one panorama -> fitted spherical Gaussians (.exr + .png strip)
- ``verify_parity``    a reference .pth against the imported port model (1e-3 bar)
- ``sphere_demo``      OmniMNIST-style digits on the sphere: PNG dumps, SphereCNN training
- ``preview``          panorama .exr -> tonemapped .png previews
- ``modify_pickles``   rescale anchor-GT pickles, or re-extract them on 42 anchors

Same flags and outputs as their emlight_tpu.cli counterparts, plus
``--device`` (CUDA unless ``cpu`` is asked; ``preview``'s tonemap is host
work); previews are .png where the JAX CLIs write .jpg, and the flags of
features not ported yet exit with their ROADMAP.md item, named by its title.
"""
