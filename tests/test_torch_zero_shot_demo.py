"""The port's zero-shot slice against cppf_tpu.eval.zero_shot with the real
``params_zs`` weights, on the demo frame cropped to a pixel box around its
two bowls (so that both packages stay fast on the CPU).  Tolerances as in
tests/test_torch_zero_shot.py."""
import jax.numpy as jnp
import numpy as np
import torch

from cppf_tpu.config import load_config as jax_load_config
from cppf_tpu.eval import zero_shot as jz
from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.core.geometry import backproject
from cppf_tpu_torch.eval import zero_shot as tz
from cppf_tpu_torch.models.convert import ASSETS, load_npz_params
from test_torch_zero_shot import _assert_detections_close

torch.set_num_threads(1)


def _demo_crop():
    """The demo frame's depth with everything outside a pixel box around its
    two bowls set to 0 (no depth), and the frame's intrinsics."""
    z = np.load(f"{ASSETS}/demo_frame.npz")
    depth = np.zeros_like(z["depth"])
    box = (slice(105, 285), slice(300, 460))      # rows, cols
    depth[box] = z["depth"][box]
    return depth, z["intrinsics"], z["plane_u"]


def test_knn_matches_jax_on_demo_cloud():
    """Neighbour sets and their order equal JAX's on real depth, where the
    float32 distance expansion ties often at the k-th neighbour (a fault of
    the first port: ~1 % of rows differed, enough to drop a demo bowl)."""
    from cppf_tpu.ops.knn import knn_indices as jax_knn
    from cppf_tpu_torch.ops.knn import knn_indices

    depth, K, _ = _demo_crop()
    pc, _ = backproject(depth, K, depth > 0)
    pc = (pc[::4] / 1000.0).astype(np.float32)
    want = np.asarray(jax_knn(jnp.asarray(pc), 60))
    np.testing.assert_array_equal(knn_indices(torch.from_numpy(pc), 60).numpy(), want)


def test_demo_crop_slice_matches():
    """The whole slice with the real params_zs weights on the cropped demo
    frame at 200 000 pairs: its ~1 100-point voting cloud gets more pairs a
    point pair than the whole frame at 5 M, so the default thresholds hold."""
    depth, K, plane_u = _demo_crop()
    params = load_npz_params(f"{ASSETS}/bowl_reg_params_zs.npz")
    snap = "checkpoints/bowl_reg/config.yaml"
    cfg_j = jax_load_config("bowl", snapshot=snap)
    cfg_t = load_config("bowl", snapshot=snap)
    cfg_j.cls_bins = cfg_t.cls_bins = False
    kw = dict(intrinsics=K, n_pairs=200000, num_rots=72, seed=0)
    det_kw = dict(seed=0)
    hm_j = jz.zero_shot_heatmap(depth, params, cfg_j, **kw)
    hm_t = tz.zero_shot_heatmap(depth, params, cfg_t, device="cpu", **kw)
    np.testing.assert_array_equal(hm_t.pc.numpy(), hm_j.pc)
    np.testing.assert_allclose(hm_t.pc_normal.numpy(), hm_j.pc_normal, atol=1e-4)
    want = jz.detect_from_heatmap(hm_j, cfg_j, **det_kw)
    assert len(want) == 2
    got = tz.detect_from_heatmap(hm_t, cfg_t, plane_u=plane_u, **det_kw)
    _assert_detections_close(got, want, cfg_t.res)
