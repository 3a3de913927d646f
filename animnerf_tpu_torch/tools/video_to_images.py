"""Video -> frames CLI with an optional center crop — counterpart of
``animnerf_tpu/tools/video_to_images.py`` (reference
tools/video_to_images.py:7-81): ``ffmpeg`` extracts the frames, the crop
reads and writes them with the port's PNG codec (``utils/image.py``)
instead of OpenCV.

    python -m animnerf_tpu_torch.tools.video_to_images --video_path in.mp4 \
        --out_dir frames --crop_w 1080 --crop_h 1080
"""

from __future__ import annotations

import argparse
import os

from animnerf_tpu_torch.utils.image import read_png, write_png
from animnerf_tpu_torch.utils.video import center_crop, video_to_images


def crop_images(img_dir: str, crop_wh: tuple, offset_xy: tuple = (0, 0)
                ) -> int:
    """Center-crop every PNG of ``img_dir`` in place; returns the count."""
    n = 0
    for f in sorted(os.listdir(img_dir)):
        if not f.endswith(".png"):
            continue
        p = os.path.join(img_dir, f)
        write_png(p, center_crop(read_png(p), crop_wh, offset_xy))
        n += 1
    return n


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_path", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--fps", type=int, default=None)
    parser.add_argument("--crop_w", type=int, default=0)
    parser.add_argument("--crop_h", type=int, default=0)
    parser.add_argument("--offset_x", type=int, default=0)
    parser.add_argument("--offset_y", type=int, default=0)
    args = parser.parse_args(argv)

    n = video_to_images(args.video_path, args.out_dir, fps=args.fps)
    print(f"extracted {n} frames")
    if args.crop_w and args.crop_h:
        crop_images(args.out_dir, (args.crop_w, args.crop_h),
                    (args.offset_x, args.offset_y))
        print(f"cropped to {args.crop_w}x{args.crop_h}")


if __name__ == "__main__":
    main()
