"""The per-frame counters of ntracer_tpu_torch over pools over the line
(the streaming walks 2.5-2.8) against the JAX package's, as
tests/test_torch_stats.py holds the others: the line (the JAX package's
``POOL_VMEM_BUDGET``, the port's ``STREAM_POOL_BYTES``) lowered to 1 KiB."""

import pytest

from _torch_helpers import glass_scene, lit_scene_3d
from test_torch_stats import check_stats

SCENES = {
    # name: (scene of package pkg, rays, over the line)
    "lit_over_the_line": (lambda pkg: lit_scene_3d(pkg=pkg), 512, True),
    "lit_glass_over_the_line": (
        lambda pkg: glass_scene(120, lit=True, pkg=pkg), 512, True),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stats_match_jax_over_the_line(name, monkeypatch):
    check_stats(name, monkeypatch, SCENES)
