"""Data-parallel training and serving over several ranks (one process per
card): ``mesh`` (the group, the rank's rows, the collectives) and
``parallel`` (the parallel train steps and serving functions).

Port of emlight_tpu/dist/ without ``auto.py`` (GSPMD data x tensor
parallelism) and ``fullsize_check.py``. The submodules are imported by name:
nn/ and losses/ use ``mesh``, and ``parallel`` uses train/.
"""
