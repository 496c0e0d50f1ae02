"""Run-config reload: a training run's opt.json snapshot as argparse defaults.

The port's own copy of ``load_run_config``, ``apply_saved_defaults`` and
``report_overrides`` (emlight_tpu/train/config_io.py:38-86). Every train CLI
of the JAX package snapshots its resolved argparse namespace to
{out_dir}/opt.json; ``--load_config PATH`` (or ``--resume`` when a snapshot
already exists in --out_dir) re-applies the saved values as argparse
*defaults*, so the original run's configuration is reproduced unless a flag
is explicitly overridden on the command line.
"""

from __future__ import annotations

import argparse
import json
import os

__all__ = ["load_run_config", "apply_saved_defaults", "report_overrides"]

# per-invocation actions that must never be replayed from a snapshot
_EXCLUDED = {"load_config", "resume"}


def load_run_config(path: str) -> dict:
    """Load a snapshot; `path` may be the json file or the run directory."""
    if os.path.isdir(path):
        path = os.path.join(path, "opt.json")
    with open(path) as f:
        return json.load(f)


def apply_saved_defaults(ap: argparse.ArgumentParser, argv, exclude=()) -> dict | None:
    """Install a saved snapshot as parser defaults before the real parse.

    The snapshot comes from --load_config if given, else from
    {--out_dir}/opt.json when --resume is set and that file exists. Explicit
    command-line flags still override (they beat defaults). Returns the saved
    dict, or None when no snapshot applies. Keys the parser doesn't know
    (e.g. loading a train snapshot into a test CLI) are ignored.
    """
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--load_config", default=None)
    pre.add_argument("--resume", action="store_true")
    pre.add_argument("--out_dir", default=ap.get_default("out_dir"))
    known, _ = pre.parse_known_args(argv)
    src = known.load_config
    if not src and known.resume and known.out_dir:
        candidate = os.path.join(known.out_dir, "opt.json")
        if os.path.exists(candidate):
            src = candidate
    if not src:
        return None
    saved = load_run_config(src)
    valid = {a.dest for a in ap._actions}
    skip = _EXCLUDED | set(exclude)
    ap.set_defaults(**{k: v for k, v in saved.items() if k in valid and k not in skip})
    print(f"run config loaded from {src}")
    return saved


def report_overrides(saved: dict | None, args: argparse.Namespace) -> dict:
    """Print and return any final-arg values that differ from the snapshot."""
    if not saved:
        return {}
    diffs = {
        k: (v, getattr(args, k))
        for k, v in saved.items()
        if k not in _EXCLUDED and hasattr(args, k) and getattr(args, k) != v
    }
    if diffs:
        print(f"WARNING: flags override the loaded snapshot: {diffs}")
    return diffs
