"""Anim-NeRF dataset: host-side loading of frames, cameras, SMPL params —
counterpart of ``animnerf_tpu/data/dataset.py``.

Consumes the reference's on-disk layout:

    root_dir/cam{NNN:03d}/camera.pkl
    root_dir/cam{NNN:03d}/images/{frame:06d}.png   (RGBA; alpha == mask)
    root_dir/{model_type}s/{frame:06d}.pkl          (per-frame SMPL params)
    root_dir/{model_type}_template.pkl              (template + fg/bg points)

camera.pkl keys: R, t, camera_f, camera_c, camera_k (5 distortion coeffs),
height, width (written by tools/people_snapshot.py:56-64).

A numpy pipeline: decoding, resizing, undistortion, morphology and pixel
subsampling stay on the host and the device receives dense float32
batches. The image operations are OpenCV's, reimplemented in
``utils/image.py``, and every random draw takes the JAX package's
generator calls in its order, so one dataset and seed give bit-equal
batches in both packages. ``Loader`` stacks items into numpy batches on a
background prefetch thread; ``training/loop.py::fit`` moves them to the
device.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from animnerf_tpu_torch.ops.ray_utils import (
    camera_to_c2w,
    draw_from_pools,
    gen_rays,
    pixel_pools,
    sample_pixels,
)
from animnerf_tpu_torch.smpl.loader import load_pickle
from animnerf_tpu_torch.utils.image import (
    read_png,
    resize_linear_u8,
    undistort_u8,
)

PARAM_KEYS = {
    "smpl": ["betas", "global_orient", "body_pose", "transl"],
    "smplh": ["betas", "global_orient", "body_pose", "transl",
              "left_hand_pose", "right_hand_pose"],
    "smplx": ["betas", "global_orient", "body_pose", "transl",
              "left_hand_pose", "right_hand_pose", "jaw_pose", "expression"],
}


class AnimNeRFDataset:
    """Index-addressable dataset of (rays, rgbs, alphas, smpl params)."""

    def __init__(
        self,
        root_dir: str,
        mode: str = "train",
        cam_IDs: Optional[list[int]] = None,
        img_wh: tuple[int, int] = (512, 512),
        frame_start_ID: int = 1,
        frame_end_ID: int = 1,
        frame_skip: int = 1,
        frame_ids_index: Optional[dict[int, int]] = None,
        white_bkgd: bool = True,
        with_background: bool = False,
        subsampletype: str = "foreground_pixel",
        subsamplesize: int = 32,
        model_type: str = "smpl",
        fore_rate: float = 0.9,
        fore_erode: int = 3,
        num_points: int = 128,
        near: float = 0.1,
        far: float = 10.0,
        seed: int = 0,
        **_: object,
    ):
        self.root_dir = root_dir
        self.mode = mode
        self.img_wh = tuple(img_wh)
        self.white_bkgd = white_bkgd
        self.with_background = with_background
        self.subsampletype = subsampletype
        self.subsamplesize = subsamplesize
        self.model_type = model_type
        self.fore_rate = fore_rate
        self.fore_erode = fore_erode
        self.num_points = num_points
        self.near, self.far = near, far

        self.frame_IDs = list(range(frame_start_ID, frame_end_ID + 1,
                                    frame_skip))
        self.num_frames = len(self.frame_IDs)
        self.cam_IDs = cam_IDs if cam_IDs is not None else [0]
        self.num_cams = len(self.cam_IDs)

        if frame_ids_index is None:
            frame_ids_index = {fid: i for i, fid in enumerate(self.frame_IDs)}
        self.frame_ids_index = frame_ids_index

        # Epoch inflation: each frame is revisited with fresh pixels until a
        # full image worth of rays has been drawn.
        self.size = self.num_frames * self.num_cams
        if mode == "train":
            self.size *= ((self.img_wh[0] * self.img_wh[1])
                          // (subsamplesize**2))

        tmpl_path = os.path.join(root_dir, f"{model_type}_template.pkl")
        tmpl = load_pickle(tmpl_path)
        self.params_template = {
            f"{k}_template": np.asarray(tmpl[k], np.float32)
            for k in PARAM_KEYS[model_type] if k in tmpl
        }
        pts = np.asarray(tmpl["points"], np.float32)
        dist = np.asarray(tmpl["distances"], np.float32)
        self.fg_points = pts[dist < -0.02]
        self.bg_points = pts[dist > 0.10]

        self._rng = np.random.default_rng(seed)
        self._ray_cache: dict[int, np.ndarray] = {}
        self._cam_cache: dict[int, dict] = {}
        # Per-(frame, cam) cache of the decoded+undistorted uint8 frame and
        # its sampling pixel pools. Training revisits every frame
        # (H*W)/(subsamplesize^2) times per epoch (epoch inflation above);
        # without the cache each 1024-pixel draw re-pays the png decode,
        # undistort and erode/dilate of the full frame. Draws from the
        # cache touch only the sampled pixels and are bit-identical to the
        # dense path. Budget in MB via ANIMNERF_FRAME_CACHE_MB (0
        # disables); FIFO eviction.
        self._frame_cache: "dict[tuple, tuple]" = {}
        self._frame_cache_lock = threading.Lock()
        self._frame_cache_bytes = 0
        self._frame_cache_budget = int(float(os.environ.get(
            "ANIMNERF_FRAME_CACHE_MB", "2048")) * 2**20)

    # ------------------------------------------------------------ loading

    def __len__(self) -> int:
        return self.size

    def load_cam(self, cam_id: int) -> dict:
        path = os.path.join(self.root_dir, f"cam{cam_id:03d}", "camera.pkl")
        return load_pickle(path)

    def load_body_model_params(self, frame_id: int) -> dict:
        path = os.path.join(self.root_dir, f"{self.model_type}s",
                            f"{frame_id:06d}.pkl")
        raw = load_pickle(path)
        return {k: np.asarray(raw[k], np.float32)
                for k in PARAM_KEYS[self.model_type] if k in raw}

    def load_image(self, frame_id: int, cam_id: int):
        path = os.path.join(self.root_dir, f"cam{cam_id:03d}", "images",
                            f"{frame_id:06d}.png")
        img = read_png(path)
        if img.ndim != 3 or img.shape[2] != 4:
            raise ValueError(f"{path!r}: frames are RGBA PNGs (alpha is "
                             f"the mask), got shape {img.shape}")
        return img[..., :3], img[..., 3]

    def _prepare_camera(self, cam_id: int) -> dict:
        """Scale intrinsics to img_wh; cache per camera."""
        if cam_id in self._cam_cache:
            return self._cam_cache[cam_id]
        cam = self.load_cam(cam_id)
        W, H = self.img_wh
        sx, sy = W / cam["width"], H / cam["height"]
        cam = dict(cam)
        cam["camera_f"] = np.asarray(cam["camera_f"], np.float64) * [sx, sy]
        cam["camera_c"] = np.asarray(cam["camera_c"], np.float64) * [sx, sy]
        cam["width"], cam["height"] = W, H
        self._cam_cache[cam_id] = cam
        return cam

    def _resize_undistort(self, img, mask, cam, undistort=True):
        """The geometric (uint8) half of _transform_image — resize then
        undistort, both on uint8 in the reference's order. Cacheable; the
        photometric half is pointwise f32 and can run on just the sampled
        pixels."""
        W, H = self.img_wh
        img = resize_linear_u8(img, (W, H))
        mask = resize_linear_u8(mask, (W, H))
        if undistort and "camera_k" in cam:
            K = np.eye(3)
            K[0, 0], K[1, 1] = cam["camera_f"]
            K[0, 2], K[1, 2] = cam["camera_c"]
            D = np.asarray(cam["camera_k"], np.float64).reshape(-1, 1)
            img = undistort_u8(img, K, D)
            mask = undistort_u8(mask, K, D)
        return img, mask

    def _transform_image(self, img, mask, cam, undistort=True):
        img, mask = self._resize_undistort(img, mask, cam, undistort)
        img = img.astype(np.float32) / 255.0
        mask = mask.astype(np.float32) / 255.0
        if not self.with_background:
            img = img * mask[..., None]
        return img, mask

    def _processed_frame(self, frame_id: int, cam_id: int):
        """(uint8 img, uint8 mask, sampling pools) for one frame, cached
        up to ANIMNERF_FRAME_CACHE_MB with FIFO eviction. Everything here
        is deterministic per frame; the per-draw work left is gathering
        the sampled pixels."""
        key_ = (frame_id, cam_id)
        hit = self._frame_cache.get(key_)
        if hit is not None:
            return hit
        cam = self._prepare_camera(cam_id)
        img, mask = self.load_image(frame_id, cam_id)
        img, mask = self._resize_undistort(img, mask, cam)
        H, W = img.shape[:2]
        pools = pixel_pools(H, W, mask.astype(np.float32) / 255.0,
                            self.subsampletype, self.fore_erode)
        # read-only pool arrays are module-level shared grids (one copy
        # for all frames) — don't charge them to this entry's budget
        nbytes = img.nbytes + mask.nbytes + sum(
            a.nbytes for p in pools.values() for a in p if a.flags.writeable)
        entry = (img, mask, pools, nbytes)
        if nbytes <= self._frame_cache_budget:
            # overlapping Loader producer threads (an abandoned epoch's
            # producer can outlive its consumer by one chunk) make
            # concurrent inserts routine — evict under a lock
            with self._frame_cache_lock:
                while (self._frame_cache_bytes + nbytes
                       > self._frame_cache_budget and self._frame_cache):
                    oldest = next(iter(self._frame_cache))
                    self._frame_cache_bytes -= (
                        self._frame_cache.pop(oldest)[3])
                self._frame_cache[key_] = entry
                self._frame_cache_bytes += nbytes
        return entry

    def get_rays(self, cam_id: int) -> np.ndarray:
        """Dense (H, W, 8) ray grid, cached per camera."""
        if cam_id in self._ray_cache:
            return self._ray_cache[cam_id]
        cam = self._prepare_camera(cam_id)
        c2w = camera_to_c2w(np.asarray(cam["R"], np.float64),
                            np.asarray(cam["t"], np.float64))
        rays = gen_rays(c2w.astype(np.float32), cam["height"], cam["width"],
                        cam["camera_f"], self.near, self.far, cam["camera_c"])
        self._ray_cache[cam_id] = rays
        return rays

    def get_points(self, rng: np.random.Generator):
        """fg/bg regularizer points + N(0,0.01) jitter."""
        n = self.num_points
        fg = self.fg_points[rng.integers(0, len(self.fg_points), n)]
        fg = fg + rng.normal(scale=0.01, size=fg.shape).astype(np.float32)
        bg = self.bg_points[rng.integers(0, len(self.bg_points), n)]
        bg = bg + rng.normal(scale=0.01, size=bg.shape).astype(np.float32)
        return fg.astype(np.float32), bg.astype(np.float32)

    # ------------------------------------------------------------ items

    def __getitem__(self, idx: int) -> dict:
        return self.get(idx, self._rng)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        idx = idx % (self.num_frames * self.num_cams)
        frame_id = self.frame_IDs[idx % self.num_frames]
        cam_id = self.cam_IDs[idx // self.num_frames]

        rays = self.get_rays(cam_id)

        if self.mode == "train" and self._frame_cache_budget > 0:
            # cached path: pointwise photometric ops run on just the
            # sampled pixels — bit-identical to the dense path below
            # (same f32 ops per element, same rng call sequence)
            img_u8, mask_u8, pools, _ = self._processed_frame(
                frame_id, cam_id)
            H, W = img_u8.shape[:2]
            coords = draw_from_pools(rng, pools, H, W, self.subsampletype,
                                     self.subsamplesize, self.fore_rate)
            r, c = coords[:, 0], coords[:, 1]
            rgbs = img_u8[r, c].astype(np.float32) / 255.0
            m = mask_u8[r, c].astype(np.float32) / 255.0
            if not self.with_background:
                rgbs = rgbs * m[:, None]
            if self.white_bkgd:
                rgbs = rgbs * m[:, None] + (1.0 - m[:, None])
            rays_s = rays[r, c]
            alphas = m[:, None]
            fg, bg = self.get_points(rng)
            params = self.load_body_model_params(frame_id)
            frame_idx = self.frame_ids_index.get(frame_id, -1)
            return {
                "cam_id": np.int32(cam_id),
                "frame_id": np.int32(frame_id),
                "frame_idx": np.int32(frame_idx),
                "rays": rays_s.astype(np.float32),
                "rgbs": rgbs.astype(np.float32),
                "alphas": alphas.astype(np.float32),
                "fg_points": fg,
                "bg_points": bg,
                **{k: v.reshape(-1).astype(np.float32)
                   for k, v in params.items()},
                **{k: v.reshape(-1).astype(np.float32)
                   for k, v in self.params_template.items()},
            }

        cam = self._prepare_camera(cam_id)
        img, mask = self.load_image(frame_id, cam_id)
        img, mask = self._transform_image(img, mask, cam)
        if self.white_bkgd:
            img = img * mask[..., None] + (1.0 - mask[..., None])

        H, W = img.shape[:2]

        if self.mode == "train":
            coords = sample_pixels(
                rng, H, W, mask, self.subsampletype, self.subsamplesize,
                self.fore_rate, self.fore_erode)
            r, c = coords[:, 0], coords[:, 1]
            rays_s = rays[r, c]
            rgbs = img[r, c]
            alphas = mask[r, c][:, None]
        else:
            rays_s = rays.reshape(-1, 8)
            rgbs = img.reshape(-1, 3)
            alphas = mask.reshape(-1, 1)

        fg, bg = self.get_points(rng)
        params = self.load_body_model_params(frame_id)
        frame_idx = self.frame_ids_index.get(frame_id, -1)

        return {
            "cam_id": np.int32(cam_id),
            "frame_id": np.int32(frame_id),
            "frame_idx": np.int32(frame_idx),
            "rays": rays_s.astype(np.float32),
            "rgbs": rgbs.astype(np.float32),
            "alphas": alphas.astype(np.float32),
            "fg_points": fg,
            "bg_points": bg,
            **{k: v.reshape(-1).astype(np.float32) for k, v in params.items()},
            **{k: v.reshape(-1).astype(np.float32)
               for k, v in self.params_template.items()},
        }


class Loader:
    """Minimal batching loader with background prefetch: stacks items
    into numpy batches. Epoch e draws its items from
    ``default_rng((seed, e))`` and shuffles with ``default_rng(seed + e)``,
    as the JAX package's loader does."""

    def __init__(self, dataset: AnimNeRFDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        # the producer's seconds per batch (item draws + stacking)
        self.produce_s: list[float] = []

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx[: len(self) * self.batch_size]

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, epoch))
        indices = self._epoch_indices(epoch)
        stop = threading.Event()

        def put(q: queue.Queue, item) -> bool:
            # bounded put that notices an abandoned consumer — a caller
            # that breaks out of the generator must not leave this thread
            # blocked on a full queue at interpreter exit
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(q: queue.Queue):
            # exceptions ride the queue to the consumer — a failed decode
            # must surface in the training loop, not masquerade as a
            # clean (short) end of epoch
            try:
                for start in range(0, len(indices), self.batch_size):
                    t0 = time.perf_counter()
                    chunk = indices[start:start + self.batch_size]
                    samples = [self.dataset.get(int(i), rng) for i in chunk]
                    batch = {k: np.stack([s[k] for s in samples])
                             for k in samples[0]}
                    self.produce_s.append(time.perf_counter() - t0)
                    if not put(q, batch):
                        return
                put(q, None)
            except BaseException as e:  # noqa: BLE001
                put(q, e)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
