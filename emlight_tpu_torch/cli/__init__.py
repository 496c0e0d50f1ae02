"""Command-line entry points of the port (``python -m emlight_tpu_torch.cli.<name>``).

- ``infer``            crop .exr -> HDR env map .exr + .png preview (+ pickles)
- ``test_regression``  crop .exr -> anchor-parameter pickles (+ _env.png)

Same flags and outputs as their emlight_tpu.cli counterparts, plus
``--device`` (CUDA unless ``cpu`` is asked).
"""
