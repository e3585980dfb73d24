"""Package version, derived from the environment instead of hardcoded.

The port's own copy of ``ntracer_tpu/_version.py`` (the analogue of the
reference's support/version.py): an installed distribution reports its own
metadata; a git checkout reports the commit it was built from as a local
version segment.
"""

import os
import subprocess

BASE_VERSION = "0.1.0"


def get_version() -> str:
    # git working tree first (a stale egg-info must not shadow it):
    # append the current commit (and -dirty when the tree has
    # uncommitted changes) as a local version segment
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(os.path.join(repo, ".git")):
        try:
            from importlib.metadata import version
            return version("ntracer-tpu")
        except Exception:
            return BASE_VERSION
    try:
        rev = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short", "HEAD"],
            check=True, capture_output=True, text=True,
            timeout=5).stdout.strip()
        dirty = subprocess.run(
            ["git", "-C", repo, "status", "--porcelain",
             "--untracked-files=no"],
            check=True, capture_output=True, text=True,
            timeout=5).stdout.strip()
        return f"{BASE_VERSION}+g{rev}" + (".dirty" if dirty else "")
    except Exception:
        return BASE_VERSION
