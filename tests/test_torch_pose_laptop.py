"""The port's laptop slice as a whole against cppf_tpu's estimate_pose
(``torch_slices``): the top-4 axis decode on the regressed right axis, with
and without the plane override (the view's stored ``laptop_up``, GT up
oriented toward the camera).  512 points, knn 16, 2048 pairs, on JAX's
draws."""
import pytest
import torch

from torch_slices import assert_slices_match, run_slice, view

torch.set_num_threads(1)


@pytest.mark.parametrize("override", [False, True])
def test_laptop_slice_matches_jax(override):
    lup = view("laptop", 0)[1]["laptop_up_0"] if override else None
    assert_slices_match(*run_slice("laptop", 0, 7, laptop_up=lup), regress_right=True,
                        laptop_up=lup)
