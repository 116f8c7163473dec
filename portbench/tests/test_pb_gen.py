"""The traffic generator: the crops that the cells serve stay the same to
the bit under the default view law, and the ``upright`` law and
``height_m`` place a gravity-aligned object as a scan from above sees it."""
import hashlib

import numpy as np
import pytest
import torch

from portbench import gen
from portbench import run as R
from portbench.tests.helpers import SMALL

# sha256 of the crops below at seed 5, as the crops were made before the
# mixes could state a view law
CROPS_SHA256 = "0e164f30ef358a9ad33b819d467074b835526960ca4e449c8c6d8d9cb50b1ce2"


def _crops(config: str, traffic: str, seed: int):
    """The crops a run of ``config`` under ``traffic`` serves, made by the
    mix's driver (small draws: they do not enter the crops; no runner)."""
    cfg = R.load_json("configs", config)
    cfg = {**cfg, **{k: v for k, v in SMALL.items() if k in cfg}}
    mix = R.load_json("traffic", traffic)
    ctx = R.Ctx({"name": f"{config}.{traffic}", "chips": 1}, cfg, mix, seed,
                torch.device("cpu"), {})
    ctx.make_runner = lambda build=None: None
    served = R.load_module("drivers", mix["driver"]).make(ctx)
    return served.crops if hasattr(served, "crops") else [c for f in served.frames for c in f]


def test_the_cells_crops_are_unchanged():
    """The 48 stream crops and the 24 frames' crops of bottle and mug."""
    h = hashlib.sha256()
    for config in ("bottle", "mug"):
        for traffic in ("stream", "frames"):
            for crop in _crops(config, traffic, 5):
                h.update(np.asarray(crop.shape, np.int64).tobytes())
                h.update(crop.tobytes())
    assert h.hexdigest() == CROPS_SHA256


UPRIGHT = {**R.load_json("traffic", "stream"), "rotation": "upright", "tilt_deg": 5.0}


def test_an_upright_view_keeps_the_mesh_up_within_its_tilt():
    rots = [rot for _, _, rot in gen.work(400, UPRIGHT, (0.2, 0.4))]
    for rot in rots:
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(rot) == pytest.approx(1.0)
    tilt = np.degrees(np.arccos(np.clip([rot[1, 1] for rot in rots], -1, 1)))
    assert tilt.max() <= 5.0 + 1e-9
    # the law's whole range: tilts near 0 and 5 degrees, yaws all round
    assert tilt.min() < 0.5 and tilt.max() > 4.5
    yaw = np.arctan2([rot[0, 2] for rot in rots], [rot[2, 2] for rot in rots])
    assert np.histogram(yaw, bins=8, range=(-np.pi, np.pi))[0].min() > 0


def test_a_scan_from_above_lies_below_the_cameras_axis():
    mix = {**UPRIGHT, "height_m": [0.9, 1.1], "distance_m": [1.5, 2.5]}
    rng = np.random.default_rng(3)
    for n, diag, rot in gen.work(4, mix, (0.2, 0.4)):
        crop = gen.make_crop("bottle", mix, diag, n, rot, rng)
        centre = (crop.min(0) + crop.max(0)) / 2
        assert -1.1 - diag / 2 <= centre[1] <= -0.9 + diag / 2
        assert 1.5 - diag / 2 <= centre[2] <= 2.5 + diag / 2


def test_an_unknown_view_law_is_refused():
    with pytest.raises(ValueError, match="sideways"):
        gen.work(2, {**UPRIGHT, "rotation": "sideways"}, (0.2, 0.4))
