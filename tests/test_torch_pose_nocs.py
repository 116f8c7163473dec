"""The port's camera and mug slices as wholes against cppf_tpu's
estimate_pose (``torch_slices``): camera regresses its right axis with the
asymmetry pair weights; mug also runs the second center pass and the
geometric right sign.  512 points, knn 16, 2048 pairs, on JAX's draws."""
import pytest
import torch

from torch_slices import assert_slices_match, run_slice

torch.set_num_threads(1)


@pytest.mark.parametrize("category,view,seed", [("camera", 0, 7), ("mug", 0, 7)])
def test_slice_matches_jax(category, view, seed):
    assert_slices_match(*run_slice(category, view, seed), regress_right=True)
