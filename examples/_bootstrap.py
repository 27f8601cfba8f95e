"""Shared demo bootstrap: repo-root import path + backend selection."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(description: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--robot", default="ur5", help="bundled robot name (default ur5)")
    args, _ = p.parse_known_args()
    if args.cpu:
        import jax

        try:
            jax.config.update("jax_platforms", "cpu")
        except RuntimeError:
            pass
    from manipulapy_tpu.utils.config import configure_cache

    configure_cache()
    return args
