"""The observation is a function of the seed."""

import json

import torch

from stackbench.registry import HERE
from stackbench.workload import geometry, make_observation

SENSOR = json.loads((HERE / "configs" / "lean-16mpix-n100.json")
                    .read_text())["sensor"]
MIX = json.loads((HERE / "traffic" / "rotate.json").read_text())


def _obs(seed):
    return make_observation(4, 192, 256, SENSOR, MIX, seed, "cpu")


def test_same_seed_same_observation():
    a, b = _obs(2**31 + 7), _obs(2**31 + 7)
    assert torch.equal(a.frames.view(torch.int16), b.frames.view(torch.int16))
    for name in ("bias", "dark", "flat", "exp_ratios"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert (a.matrices == b.matrices).all()


def test_two_seeds_differ():
    a, b = _obs(1), _obs(2)
    assert not torch.equal(a.frames.view(torch.int16),
                           b.frames.view(torch.int16))
    assert not (a.matrices == b.matrices).all()


def test_geometry_follows_the_mix():
    geo = geometry(6, 192, 256, SENSOR, MIX, 3)
    mats = geo["mats"]
    assert (mats[0] == [[1, 0, 0], [0, 1, 0]]).all()
    theta = abs(__import__("numpy").degrees(
        __import__("numpy").arctan2(mats[1:, 1, 0], mats[1:, 0, 0])))
    assert ((theta >= 0.1 - 1e-9) & (theta <= 0.25 + 1e-9)).all()
    still = dict(MIX, rotation_deg=None)
    assert (geometry(6, 192, 256, SENSOR, still, 3)["mats"][:, 0, 1] == 0).all()


def test_frames_are_raw_uint16_with_the_sky():
    obs = _obs(5)
    assert obs.frames.dtype == torch.uint16
    raw = obs.frames.view(torch.int16).to(torch.int32) & 0xFFFF
    sky = SENSOR["sky_adu"] * 0.95 + SENSOR["bias_adu"] \
        + SENSOR["exp_ratio"] * SENSOR["dark_adu"]
    assert abs(float(raw.float().median()) - sky) < 60
