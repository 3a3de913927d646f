"""In-process multi-person SMPL-from-video driver (the VIBE pipeline) —
counterpart of ``animnerf_tpu/tools/vibe_driver.py`` (reference
tools/vibe.py:48-257).

Detect and track people over an image folder, drop tracklets shorter
than MIN_NUM_FRAMES, run a temporal SMPL regressor per tracklet on square
bbox crops (scale 1.1) in large batches, convert the weak-perspective
crop cameras to full-image cameras, and write ``vibe_output.pkl`` with
per-person {pred_cam, orig_cam, verts, pose, betas, joints3d, joints2d,
bboxes, frame_ids}, as the JAX tool writes it.

The reference drives two external CUDA networks (a YOLO person detector
through the multi_person_tracker package and the VIBE GRU regressor from
its git submodule), whose weights are not redistributable, so here they
are injected callables with the JAX tool's contracts. The crops are
resized by ``utils/image.py::resize_linear_u8``, OpenCV's uint8
``INTER_LINEAR`` bit for bit, so they equal the JAX tool's crops where
it runs ``cv2.resize``. Frames are read as PNG (``utils/image.py::
read_rgb``); a JPEG frame raises ``ValueError`` unless ``read_image``
decodes it. ``tools/vibe.py`` runs an external VIBE checkout instead;
``tools/convert_vibe.py`` reads the pickle either way.

Contracts:
  detector_fn(image (H, W, 3) uint8 RGB) -> (N, 4) float32 person boxes
      as [x1, y1, x2, y2] (any N >= 0 per frame).
  model_fn(crops (T, S, S, 3) float32 in [0, 1]) -> dict with
      'cam' (T, 3) weak-perspective [s, tx, ty], 'pose' (T, 72) axis-angle,
      'betas' (T, 10); optional 'verts' (T, V, 3), 'joints3d' (T, J, 3);
      numpy arrays or torch tensors on any device. Called in chunks of
      ``batch_size`` frames (the reference batches 450 crops through the
      GRU per forward, tools/vibe.py:124).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from animnerf_tpu_torch.utils.image import read_rgb, resize_linear_u8

MIN_NUM_FRAMES = 25   # reference tools/vibe.py:44
BBOX_SCALE = 1.1      # reference tools/vibe.py:67
CROP_SIZE = 224       # VIBE input resolution
EXTS = (".jpg", ".jpeg", ".png")


# --------------------------------------------------------------- tracking

def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) [x1 y1 x2 y2] -> (N, M) IoU."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


@dataclass
class _Track:
    tid: int
    frames: list = field(default_factory=list)
    boxes: list = field(default_factory=list)   # xyxy
    misses: int = 0


def track_people(detections: "list[np.ndarray]", iou_thresh: float = 0.3,
                 max_gap: int = 2) -> "dict[int, dict]":
    """Greedy IoU tracker over per-frame detections.

    The reference uses the multi_person_tracker package (YOLO + SORT:
    Kalman prediction + Hungarian matching). This is a deliberate
    simplification for the same job — people in these capture setups move
    slowly relative to frame rate, so greedy best-IoU matching with a
    small miss tolerance recovers the same tracklets; the Kalman motion
    model matters only for fast crossing targets. Output matches MPT's
    `output_format='dict'`: {track_id: {'bbox': (F, 4) [cx, cy, w, h],
    'frames': (F,) int}} (consumed at tools/vibe.py:108-110).
    """
    tracks: list[_Track] = []
    done: list[_Track] = []
    next_id = 1
    for f, dets in enumerate(detections):
        dets = np.asarray(dets, np.float32).reshape(-1, 4)
        live = [t for t in tracks if t.misses <= max_gap]
        matched_d: set[int] = set()
        if live and len(dets):
            ious = box_iou(np.stack([t.boxes[-1] for t in live]), dets)
            # greedy: repeatedly take the globally best remaining pair
            order = np.dstack(np.unravel_index(
                np.argsort(-ious, axis=None), ious.shape))[0]
            matched_t: set[int] = set()
            for ti, di in order:
                if ious[ti, di] < iou_thresh:
                    break
                if ti in matched_t or di in matched_d:
                    continue
                matched_t.add(int(ti))
                matched_d.add(int(di))
                t = live[ti]
                t.frames.append(f)
                t.boxes.append(dets[di])
                t.misses = 0
        for t in tracks:
            if t.frames and t.frames[-1] != f:
                t.misses += 1
        done.extend(t for t in tracks if t.misses > max_gap)
        tracks = [t for t in tracks if t.misses <= max_gap]
        for di in range(len(dets)):
            if di not in matched_d:
                t = _Track(next_id, [f], [dets[di]])
                next_id += 1
                tracks.append(t)

    out = {}
    for t in tracks + done:
        b = np.stack(t.boxes)
        cxcywh = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                           b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)
        out[t.tid] = {"bbox": cxcywh.astype(np.float32),
                      "frames": np.asarray(t.frames, np.int64)}
    return out


# ----------------------------------------------------------------- crops

def crop_square(img: np.ndarray, cx: float, cy: float, w: float, h: float,
                scale: float = BBOX_SCALE, out: int = CROP_SIZE) -> np.ndarray:
    """Square crop of side max(w, h) * scale centred on (cx, cy), zero
    padded at image borders, resized to (out, out) by OpenCV's uint8
    linear resize, float32 in [0, 1] (the reference's Inference dataset
    crop convention); ``img`` is uint8."""
    side = int(round(max(w, h) * scale))
    side = max(side, 2)
    H, W = img.shape[:2]
    x0 = int(round(cx - side / 2))
    y0 = int(round(cy - side / 2))
    patch = np.zeros((side, side, 3), img.dtype)
    sx0, sy0 = max(0, -x0), max(0, -y0)
    ix0, iy0 = max(0, x0), max(0, y0)
    ix1, iy1 = min(W, x0 + side), min(H, y0 + side)
    if ix1 > ix0 and iy1 > iy0:
        patch[sy0:sy0 + (iy1 - iy0), sx0:sx0 + (ix1 - ix0)] = \
            img[iy0:iy1, ix0:ix1]
    patch = resize_linear_u8(patch, (out, out))
    return np.asarray(patch, np.float32) / 255.0


# ------------------------------------------------------ camera conversion

def convert_crop_cam_to_orig_img(cam: np.ndarray, bbox: np.ndarray,
                                 img_width: int,
                                 img_height: int) -> np.ndarray:
    """Weak-perspective crop camera [s, tx, ty] + bbox [cx, cy, w, h] ->
    full-image camera [sx, sy, tx, ty] (the formula of VIBE's
    demo_utils.convert_crop_cam_to_orig_img, used at reference
    tools/vibe.py:163-168): the crop scale is re-expressed relative to the
    image half-extents and the bbox centre offset is folded into the
    translation."""
    cam = np.asarray(cam, np.float32)
    bbox = np.asarray(bbox, np.float32)
    cx, cy, h = bbox[:, 0], bbox[:, 1], np.maximum(bbox[:, 2], bbox[:, 3])
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam[:, 0] * (1.0 / (img_width / h))
    sy = cam[:, 0] * (1.0 / (img_height / h))
    tx = ((cx - hw) / hw / np.maximum(sx, 1e-9)) + cam[:, 1]
    ty = ((cy - hh) / hh / np.maximum(sy, 1e-9)) + cam[:, 2]
    return np.stack([sx, sy, tx, ty], axis=-1)


# ----------------------------------------------------------------- driver

def _numpy(x) -> np.ndarray:
    """A regressor output (numpy, or a torch tensor on any device) as a
    float32 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def list_frames(image_folder: str) -> "list[str]":
    names = sorted(n for n in os.listdir(image_folder)
                   if os.path.splitext(n)[-1].lower() in EXTS)
    return [os.path.join(image_folder, n) for n in names]


def run_vibe_driver(
    image_folder: str,
    output_folder: str,
    detector_fn: Callable[[np.ndarray], np.ndarray],
    model_fn: Callable[[np.ndarray], dict],
    min_frames: int = MIN_NUM_FRAMES,
    batch_size: int = 450,
    bbox_scale: float = BBOX_SCALE,
    crop_size: int = CROP_SIZE,
    iou_thresh: float = 0.3,
    read_image: Optional[Callable[[str], np.ndarray]] = None,
) -> "dict[int, dict]":
    """Full in-process pipeline; returns the vibe_results dict and writes
    ``<output_folder>/vibe_output.pkl`` (the file tools/convert_vibe.py
    reads — reference tools/vibe.py:105-196). ``read_image`` (path ->
    (H, W, 3) uint8 RGB) defaults to ``read_rgb``: PNG frames only."""
    if read_image is None:
        read_image = read_rgb

    paths = list_frames(image_folder)
    if not paths:
        raise FileNotFoundError(f"no frames under {image_folder!r}")
    first = read_image(paths[0])
    orig_h, orig_w = first.shape[:2]

    # detect + track
    detections = [detector_fn(read_image(p)) for p in paths]
    tracking = track_people(detections, iou_thresh=iou_thresh)

    # drop short tracklets (reference tools/vibe.py:79-82)
    for tid in list(tracking):
        if tracking[tid]["frames"].shape[0] < min_frames:
            del tracking[tid]

    vibe_results: dict[int, dict] = {}
    for tid, track in tracking.items():
        bboxes = track["bbox"]
        frames = track["frames"]
        outs: dict[str, list] = {"cam": [], "pose": [], "betas": [],
                                 "verts": [], "joints3d": []}
        for start in range(0, len(frames), batch_size):
            fr = frames[start:start + batch_size]
            bb = bboxes[start:start + batch_size]
            crops = np.stack([
                crop_square(read_image(paths[f]), *bb[i],
                            scale=bbox_scale, out=crop_size)
                for i, f in enumerate(fr)])
            out = model_fn(crops)
            for k in ("cam", "pose", "betas"):
                outs[k].append(_numpy(out[k]))
            for k in ("verts", "joints3d"):
                if k in out and out[k] is not None:
                    outs[k].append(_numpy(out[k]))

        pred_cam = np.concatenate(outs["cam"])
        orig_cam = convert_crop_cam_to_orig_img(pred_cam, bboxes,
                                                orig_w, orig_h)
        vibe_results[tid] = {
            "pred_cam": pred_cam,
            "orig_cam": orig_cam,
            "verts": np.concatenate(outs["verts"]) if outs["verts"] else None,
            "pose": np.concatenate(outs["pose"]),
            "betas": np.concatenate(outs["betas"]),
            "joints3d": (np.concatenate(outs["joints3d"])
                         if outs["joints3d"] else None),
            "joints2d": None,
            "bboxes": bboxes,
            "frame_ids": frames,
        }

    os.makedirs(output_folder, exist_ok=True)
    out_path = os.path.join(output_folder, "vibe_output.pkl")
    with open(out_path, "wb") as f:
        pickle.dump(vibe_results, f)
    return vibe_results
