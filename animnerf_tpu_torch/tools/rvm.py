"""RobustVideoMatting driver: frames -> RGBA PNGs, the matte in alpha —
counterpart of ``animnerf_tpu/tools/rvm.py`` (reference tools/rvm.py:19-63).

RVM is an external torch model; this driver owns everything around it:
the frame order, the recurrent-state warm-up, the alpha merge and the
PNG output. The model is an injected callable with RVM's recurrent
signature

    model(src, r1, r2, r3, r4, downsample_ratio)
        -> (fgr, pha, r1, r2, r3, r4)

or a TorchScript file (``--checkpoint``) loaded onto ``device``: the card
unless ``device="cpu"``. ``src`` is the (1, 3, H, W) float32 RGB frame in
[0, 1] on that device; ``pha`` comes back to the host. The first
``warmup`` frames are fed first in reverse order so the recurrent state
settles before the first real output (reference :31); those outputs are
discarded and only their state is kept. The alpha is
``(pha * 255).astype(uint8)``, truncated as the JAX tool does. The JAX
tool writes BGRA through ``cv2.imwrite``, which stores RGBA; the port
writes the same RGBA through ``utils/image.py::write_png``.

Frames are PNGs read by ``utils/image.py::read_rgb``: a JPEG frame raises
``ValueError`` unless an injected ``read_image`` decodes it. The JAX
tool's torch-hub route downloads the model and has no counterpart here:
without a model or a checkpoint the driver raises.

    python -m animnerf_tpu_torch.tools.rvm --images_dir frames \
        --out_dir matted --checkpoint rvm_resnet50.torchscript
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device
from animnerf_tpu_torch.utils.image import read_rgb, write_png


def load_torchscript(checkpoint: str, device: torch.device) -> Callable:
    """A TorchScript RVM on ``device`` as the driver's callable."""
    model = torch.jit.load(checkpoint, map_location=device).eval()

    def call(src, *rec_and_ratio):
        with torch.no_grad():
            return model(src, *rec_and_ratio)

    return call


def run_rvm(images_dir: str, out_dir: str,
            model: Optional[Callable] = None, checkpoint: str = "",
            warmup: int = 4, downsample_ratio: float = 0.25,
            device: DeviceLike = None,
            read_image: Optional[Callable[[str], np.ndarray]] = None) -> int:
    """Matte every png / jpg of ``images_dir`` into RGBA PNGs in
    ``out_dir``; returns the number of frames written. ``model``: the
    injected RVM callable, else the TorchScript ``checkpoint``;
    ``read_image``: path -> (H, W, 3) uint8 RGB (default ``read_rgb``)."""
    dev = resolve_device(device)
    if model is None:
        if not checkpoint:
            raise ValueError(
                "run_rvm needs an RVM model: pass model= or a TorchScript "
                "checkpoint (--checkpoint); the torch-hub download of the "
                "JAX tool has no counterpart in the port")
        model = load_torchscript(checkpoint, dev)
    read_image = read_image or read_rgb

    os.makedirs(out_dir, exist_ok=True)
    frames = sorted(f for f in os.listdir(images_dir)
                    if f.endswith((".png", ".jpg")))
    # warm-up: the first frames again in reverse first (reference
    # tools/rvm.py:31), the skip clipped to the prefix there is
    n_warm = len(frames[:warmup])
    order = frames[:warmup][::-1] + frames
    rec = [None] * 4
    n_out = 0
    for i, name in enumerate(order):
        rgb = read_image(os.path.join(images_dir, name))
        src = torch.from_numpy(rgb).float().permute(2, 0, 1)[None] / 255.0
        fgr, pha, *rec = model(src.to(dev), *rec, downsample_ratio)
        if i < n_warm:
            continue  # warm-up output discarded; only its state is kept
        alpha = (pha[0, 0].cpu().numpy() * 255).astype(np.uint8)
        out_name = os.path.splitext(name)[0] + ".png"
        write_png(os.path.join(out_dir, out_name), np.dstack([rgb, alpha]))
        n_out += 1
    return n_out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--images_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default="",
                        help="RVM TorchScript file")
    parser.add_argument("--warmup", type=int, default=4)
    parser.add_argument("--downsample_ratio", type=float, default=0.25)
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)
    n = run_rvm(args.images_dir, args.out_dir, checkpoint=args.checkpoint,
                warmup=args.warmup, downsample_ratio=args.downsample_ratio,
                device=args.device)
    print(f"matted {n} frames")


if __name__ == "__main__":
    main()
