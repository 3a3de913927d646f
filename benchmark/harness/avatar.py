"""The fields' weights a run hands to the program and to the reference:
{"scene.nerf.<layer>.weight" / ".bias": tensor, the same for
"scene.nerf_fine"} in the (out, in) layout.

- ``"weights": "seeded"`` (default): drawn on the device from the seed in
  one call, each layer's weight a normal clipped to two standard
  deviations with variance 1 / fan_in (the field's initialisation), zero
  biases; ``sigma_bias`` is added to both sigma heads (an opaque shell
  for views of an untrained field).
- ``"weights": "checkpoint"``: a trained field's ``anim_nerf.npz`` under
  ``path`` (flax layout: ``<net>/params/<layer>/kernel`` (in, out)).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from reference import field as fld

NETS = ("nerf", "nerf_fine")
TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def field_weights(avatar: dict, config: dict, seed: int, device,
                  root: str) -> dict:
    shapes = fld.layer_shapes(config["arch"])
    out = {}
    if avatar.get("weights", "seeded") == "checkpoint":
        with np.load(os.path.join(root, avatar["path"], "anim_nerf.npz")) as z:
            for net in NETS:
                for layer, (o, i) in shapes.items():
                    k = z[f"{net}/params/{layer}/kernel"]
                    if k.shape != (i, o):
                        raise ValueError(f"{net}.{layer}: {k.shape} is not "
                                         f"the configuration's {(i, o)}")
                    out[f"scene.{net}.{layer}.weight"] = torch.tensor(
                        k.T.copy(), device=device)
                    out[f"scene.{net}.{layer}.bias"] = torch.tensor(
                        z[f"{net}/params/{layer}/bias"], device=device)
        return out
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    total = len(NETS) * sum(o * i for o, i in shapes.values())
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    pos = 0
    for net in NETS:
        for layer, (o, i) in shapes.items():
            w = flat[pos:pos + o * i].reshape(o, i) * (
                math.sqrt(1.0 / i) / TRUNC_STD)
            pos += o * i
            b = torch.zeros(o, device=device)
            if layer == "sigma":
                b += float(avatar.get("sigma_bias", 0.0))
            out[f"scene.{net}.{layer}.weight"] = w
            out[f"scene.{net}.{layer}.bias"] = b
    return out
