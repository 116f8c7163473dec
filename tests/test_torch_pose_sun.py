"""The port's sofa and table slices as wholes against cppf_tpu's
estimate_pose (``torch_slices``): sofa regresses its right axis and
nothing else; table also runs the coplanar center filter, the asymmetry
pair weights and the direct geometric right sign, at 3 cm voxels.  512
points, knn 16, 2048 pairs, on JAX's draws.  At 3 cm, 2048 pairs leave a
table only some 5-20 back-vote survivors."""
import numpy as np
import torch

from torch_slices import assert_slices_match, run_slice

torch.set_num_threads(1)


def test_slice_matches_jax():
    assert_slices_match(*run_slice("sofa", 0, 7), regress_right=True)


def test_table_slice_matches_jax():
    """Table's view 0 against JAX run op by op, in full.  Against JAX's
    compiled program all but the sign of up agree: of the 5 back-vote
    survivors, one pair's normal lies in the table top and ⟂ its axis, so
    the sign of n·âb that canonicalises it for the aux bit is float rounding
    (±1e-8), and XLA's fused program rounds it the other way; that one aux
    target tips the up-or-down BCE (0.690 against 0.790).  The port rounds
    as JAX does op by op."""
    out_e, out_t, sphere, draws = run_slice("table", 0, 7, eager=True)
    assert_slices_match(out_e, out_t, sphere, draws, regress_right=True, min_survivors=5)
    out_j = run_slice("table", 0, 7)[0]
    np.testing.assert_allclose(out_t.T.numpy(), np.asarray(out_j.T), atol=1e-6)
    np.testing.assert_allclose(out_t.right.numpy(), np.asarray(out_j.right), atol=1e-6)
    np.testing.assert_allclose(np.abs(out_t.up.numpy()), np.abs(np.asarray(out_j.up)),
                               atol=1e-6)
    np.testing.assert_allclose(out_t.scale.numpy(), np.asarray(out_j.scale), rtol=1e-5)
    assert int(out_t.n_filtered) == int(out_j.n_filtered)


def test_table_coplanar_filter_slice_matches_jax():
    """Table's view 1 at 2048 points, where the coplanar filter drops a
    quarter of the pairs from the center vote (at 512 points every pair of
    a table view lies in its top, and the filter keeps all), against JAX's
    compiled program."""
    assert_slices_match(*run_slice("table", 1, 7, n_points=2048), regress_right=True,
                        min_survivors=5)
