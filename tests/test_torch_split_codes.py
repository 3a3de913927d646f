"""``AnimNeRFSystem.render`` and the dense ``loss_fn`` against the JAX
package on the CPU for latent codes + DeRF (with ``frame_idx``) and a shared fine field: the cases of
``tests/test_torch_split_render.py`` (rig, routes, noise and tolerances
are stated there).
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_split_render import check_loss, check_render  # noqa: E402

torch.set_num_threads(1)

HERE = ('codes_derf', 'share_fine')


@pytest.mark.parametrize("name", HERE)
def test_render_matches_jax(name):
    check_render(name)


@pytest.mark.parametrize("name", HERE)
def test_dense_loss_matches_jax(name):
    check_loss(name)
