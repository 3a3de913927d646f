"""VIBE SMPL-estimation wrapper for an external VIBE checkout —
counterpart of ``animnerf_tpu/tools/vibe.py`` (reference
tools/vibe.py:48-257).

VIBE is an external research model (a CUDA torch git submodule in the
reference) that cannot be vendored here: this wrapper runs an existing
checkout's ``demo.py`` on a video and returns the path of the
``vibe_output.pkl`` it writes, the file ``tools/convert_vibe.py`` reads:

    {track_id: {'orig_cam': (F, 4), 'betas': (F, 10), 'pose': (F, 72),
                'frame_ids': (F,)}}

``tools/vibe_driver.py`` runs the same pipeline in process with the
detector and the regressor injected.

    python -m animnerf_tpu_torch.tools.vibe --vibe_repo VIBE \
        --video_path in.mp4 --out_dir vibe_out
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def run_vibe(vibe_repo: str, video_path: str, out_dir: str,
             tracker_batch: int = 12) -> str:
    """Invoke an external VIBE checkout's demo on ``video_path``; returns
    the path of the produced vibe_output.pkl."""
    demo = os.path.join(vibe_repo, "demo.py")
    if not os.path.exists(demo):
        raise FileNotFoundError(
            f"VIBE checkout not found at {vibe_repo!r} (expected demo.py). "
            "VIBE is an external CUDA tool; run it elsewhere and place "
            "vibe_output.pkl next to the frames, then use convert_vibe.")
    subprocess.run(
        [sys.executable, demo, "--vid_file", video_path,
         "--output_folder", out_dir, "--tracker_batch_size",
         str(tracker_batch), "--no_render"],
        check=True, cwd=vibe_repo)
    name = os.path.splitext(os.path.basename(video_path))[0]
    return os.path.join(out_dir, name, "vibe_output.pkl")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--vibe_repo", type=str, required=True,
                        help="path to an existing VIBE checkout")
    parser.add_argument("--video_path", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    args = parser.parse_args(argv)
    out = run_vibe(args.vibe_repo, args.video_path, args.out_dir)
    print(f"VIBE output at {out}")


if __name__ == "__main__":
    main()
