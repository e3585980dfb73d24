"""Frames of 10-D scenes (the grid walks, kernels 2.9 and 2.10) through
ntracer_tpu_torch vs the JAX package and the scalar oracle: the check of
test_torch_grid_frame9.py on the 10-orthoplex: with the smaller one that
shades it, and as a mirror over a mirror floor with reflection depth 2."""

import pytest

from test_torch_grid_frame9 import check_frame

D = 10


@pytest.mark.parametrize("companion", ["shade", "floor"])
def test_frame_matches_jax_and_oracle(companion, monkeypatch):
    check_frame(D, companion, monkeypatch)
