"""The port's config defaults against the JAX package's default config."""

from __future__ import annotations

import pytest
import torch

from animnerf_tpu.config import finalize, get_default_config
from animnerf_tpu_torch.data.synthetic import make_body_model
from animnerf_tpu_torch.system import AnimNeRFSystem, num_frames

torch.set_num_threads(1)


def test_bare_config_matches_the_jax_default_config():
    """AnimNeRFSystem({}) takes the sample counts and the body-parameter
    frame count of ``finalize(get_default_config())``."""
    ref = finalize(get_default_config())
    system = AnimNeRFSystem({}, make_body_model(64, 8, seed=1),
                            device="cpu")
    assert system.renderer_cfg.n_coarse == ref.n_samples
    assert system.renderer_cfg.n_fine == ref.n_importance == 16
    assert system.scene_cfg.use_fine
    assert system.body_params["global_orient"].shape[0] == ref.num_frames
    assert ref.num_frames == 100


@pytest.mark.parametrize("train, want", [
    ({"frame_start_ID": 1, "frame_end_ID": 8, "frame_skip": 1}, 8),
    ({"frame_start_ID": 3, "frame_end_ID": 30, "frame_skip": 5}, 6),
    ({"frame_end_ID": 40}, 10),
])
def test_num_frames_follows_the_training_frame_range(train, want):
    """Without num_frames the count is len(range(start, end + 1, skip));
    a given num_frames wins."""
    assert num_frames({"train": train}) == want
    assert num_frames({"train": train, "num_frames": 3}) == 3
