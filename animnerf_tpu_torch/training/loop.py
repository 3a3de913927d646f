"""The training loop from a dataset on disk: epochs, logging, checkpoints,
validation, evaluation — counterpart of ``animnerf_tpu/training/loop.py``.

``fit`` builds the system from the config (the body model from its model
file), reads the training frames through ``AnimNeRFDataset`` / ``Loader``,
takes steps of the engine the JAX package's ``auto`` picks
(``RowsCompactTrainer`` for the flagship configuration, ``DenseTrainer``
for every other; a line names it), renders one validation frame per epoch
(``make_eval_step`` in slabs of 32,768 rays), and writes the top-k and
``last`` checkpoints in the JAX package's layout; ``evaluate`` scores a
split's frames with PSNR and SSIM, and LPIPS on the card where its
weights file exists (``models/evaluator.py``). Log lines,
``metrics.jsonl`` keys, TensorBoard events, the checkpoint cadence,
refinement (``train.ckpt_path``, ``model_names_to_load``,
``pretrained_model_requires_grad``) and resume follow the JAX package.
Resume continues the data stream where the checkpoint left it (the
epoch's first batches are drawn again and skipped), so a resumed run
takes the same steps as one that did not stop. ``ANIMNERF_PROFILE``
writes a ``torch.profiler`` trace of steps 2-4.

Both entry points run on the card unless ``device="cpu"`` is asked for.
Under ``torch.distributed`` (``parallel/mesh.py::init_distributed``, the
train and test CLIs under torchrun) they run on every rank, as the JAX
package's run on every device: ``fit`` over ``mesh_for_batch`` (the
largest number of ranks that divides the batch; a rank left out waits at
the end), ``evaluate`` over every rank. Every rank's ``Loader`` draws the
global batch from the same seed and keeps its rows (``place_batch``);
validation and evaluation slabs are 32,768 rays a rank; the mesh's rank 0
alone writes checkpoints, logs, images and scores, and the others wait at
a barrier after each write; resume and ``evaluate`` load the checkpoint
on every rank, so across hosts ``checkpoints_dir`` must be a directory
that every rank sees (``check_visible`` raises on every rank where one
does not); ``evaluate`` returns the same means on every rank.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from animnerf_tpu_torch.config import CfgNode
from animnerf_tpu_torch.data.dataset import AnimNeRFDataset, Loader
from animnerf_tpu_torch.models.body_params import (
    load_body_params_from_dataset,
)
from animnerf_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_object,
    check_visible,
    make_mesh,
    mesh_for_batch,
)
from animnerf_tpu_torch.parallel.train_pjit import (
    make_sharded_eval_step,
    make_sharded_trainer,
)
from animnerf_tpu_torch.system import AnimNeRFSystem
from animnerf_tpu_torch.training.checkpoints import (
    CheckpointManager,
    load_params,
    load_train_state,
    save_train_state,
    system_params,
)
from animnerf_tpu_torch.training.system import _schedule, make_optimizer
from animnerf_tpu_torch.utils.device import DeviceLike

# rays per eval_step call and rank: a 512^2 frame renders in 8 slabs on
# one rank
EVAL_SLAB = 32768


class MetricLogger:
    """stdout + JSONL + TensorBoard-event scalar/image logger."""

    def __init__(self, log_dir: str, exp_name: str):
        from animnerf_tpu_torch.utils.tb_events import EventWriter

        self.dir = os.path.join(log_dir, exp_name)
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = EventWriter(self.dir)

    def log(self, step: int, scalars: dict, prefix: str = "train") -> None:
        tagged = {f"{prefix}/{k}": float(v) for k, v in scalars.items()}
        self._f.write(json.dumps({"step": step, **tagged}) + "\n")
        self._f.flush()
        self._tb.add_scalars(tagged, step)

    def log_image(self, step: int, tag: str, img) -> None:
        """img: uint8 (H, W, 3), e.g. the GT | pred | depth triptych."""
        self._tb.add_image(tag, img, step)

    def close(self):
        self._f.close()
        self._tb.close()


def build_system(cfg: CfgNode, device: DeviceLike = None) -> AnimNeRFSystem:
    """The system of a config: the body model from ``cfg.model_path``,
    the field's initial weights drawn from ``cfg.seed``."""
    from animnerf_tpu_torch.smpl.body_model import create

    body_model = create(cfg.model_path, cfg.model_type, cfg.gender)
    return AnimNeRFSystem(cfg, body_model, device=device, seed=cfg.seed)


def dict_flat(cfg: CfgNode) -> dict:
    out = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out[k] = {kk: vv for kk, vv in v.items()}
        else:
            out[k] = v
    return out


def _frame_dataset(cfg: CfgNode, split: str) -> AnimNeRFDataset:
    """Full frames of the val or test split (mode 'val')."""
    sp = cfg[split]
    return AnimNeRFDataset(
        cfg.root_dir, mode="val", img_wh=tuple(cfg.img_wh),
        frame_start_ID=sp.frame_start_ID, frame_end_ID=sp.frame_end_ID,
        frame_skip=sp.frame_skip, cam_IDs=sp.cam_IDs,
        model_type=cfg.model_type, white_bkgd=cfg.white_bkgd,
        frame_ids_index={fid: i for i, fid in enumerate(cfg.frame_IDs)})


def render_frame(eval_step, batch: dict, slab: int = EVAL_SLAB) -> dict:
    """One numpy frame batch (1, R, ...) through a sharded eval step
    (``make_sharded_eval_step``) in slabs of ``slab`` rays -> numpy
    outputs (1, R, C)."""
    n = batch["rays"].shape[1]
    outs = []
    for i in range(0, n, slab):
        sub = dict(batch)
        for k in ("rays", "rgbs", "alphas"):
            sub[k] = batch[k][:, i:i + slab]
        out = eval_step(sub)
        outs.append({k: v.float().cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs], axis=1)
            for k in outs[0]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(cfg: CfgNode, profile: bool = False, device: DeviceLike = None,
        stats: Optional[dict] = None) -> str:
    """Train per the config -> the checkpoint directory. ``stats``, when
    given, collects host-clock timings: ``step_s`` (each step, synchronised),
    ``wait_s`` (time blocked on the loader), ``produce_s`` (the loader's
    producer per batch), ``val_s``, ``save_s``, each step's
    ``compact_count`` (coarse survivors), the logged ``losses`` as
    (step, loss) and the trained ``system``. Under a process group it runs
    on every rank (the module's docstring); ``cfg.mesh_shape`` is not read,
    as in the JAX package."""
    mesh = mesh_for_batch(cfg.train.batch_size, device)
    ckpt_dir = os.path.join(cfg.checkpoints_dir, cfg.exp_name)
    if not mesh.active:  # the batch does not split over this rank
        barrier()
        return ckpt_dir
    dev = mesh.device
    main = mesh.is_main
    system = build_system(cfg, dev)

    train_ds = AnimNeRFDataset(
        cfg.root_dir, mode="train", img_wh=tuple(cfg.img_wh),
        frame_start_ID=cfg.train.frame_start_ID,
        frame_end_ID=cfg.train.frame_end_ID,
        frame_skip=cfg.train.frame_skip, cam_IDs=cfg.train.cam_IDs,
        subsampletype=cfg.train.subsampletype,
        subsamplesize=cfg.train.subsamplesize,
        model_type=cfg.model_type, fore_rate=cfg.train.fore_rate,
        fore_erode=cfg.train.fore_erode, white_bkgd=cfg.white_bkgd,
        frame_ids_index={fid: i for i, fid in enumerate(cfg.frame_IDs)},
        seed=cfg.seed,
    )
    loader = Loader(train_ds, cfg.train.batch_size, shuffle=True,
                    seed=cfg.seed)
    steps_per_epoch = max(len(loader), 1)
    system.set_body_params(load_body_params_from_dataset(
        cfg.frame_IDs, cfg.root_dir, cfg.model_type))

    # refinement / transfer: load the named groups of a pretrained
    # checkpoint; a loaded field stays frozen unless
    # pretrained_model_requires_grad (e.g. *_refine.yaml optimises only
    # the per-frame body params of new frames)
    train_field = True
    if cfg.train.ckpt_path:
        check_visible(mesh, cfg.train.ckpt_path)
        groups = cfg.train.model_names_to_load
        load_params(cfg.train.ckpt_path, system, groups)
        if (groups and "anim_nerf" in groups
                and not cfg.train.pretrained_model_requires_grad):
            train_field = False
    optimizer, scheduler = make_optimizer(system, steps_per_epoch,
                                          train_field=train_field)
    train_step, place_state, place_batch = make_sharded_trainer(
        system, optimizer, scheduler, mesh, seed=cfg.seed + 1)
    trainer = train_step.__self__
    start_step = 0
    if cfg.train.resume and cfg.train.ckpt_path:
        start_step = load_train_state(cfg.train.ckpt_path, system,
                                      optimizer, scheduler,
                                      trainer.generator)
        trainer.steps = start_step
    place_state(system)

    manager = logger = None
    if main:
        manager = CheckpointManager(ckpt_dir, monitor="psnr", mode="max",
                                    save_top_k=cfg.train.save_top_k)
        logger = MetricLogger(cfg.logs_dir, cfg.exp_name)
    val_ds = _frame_dataset(cfg, "val")
    eval_step = make_sharded_eval_step(system, mesh)
    lr_factor = _schedule(system.train_cfg, float(cfg.train.lr),
                          steps_per_epoch)
    timing = stats is not None
    if timing:
        for k in ("step_s", "wait_s", "val_s", "save_s", "compact_count",
                  "losses"):
            stats.setdefault(k, [])
        stats["produce_s"] = loader.produce_s
        stats["system"] = system

    def run_validation(epoch: int) -> Optional[dict]:
        """The validation frame on every rank; rank 0 scores and writes."""
        from animnerf_tpu_torch.models.evaluator import psnr as psnr_np, ssim

        batch = {k: np.asarray(v)[None] for k, v in val_ds[0].items()}
        t0 = time.perf_counter()
        out = render_frame(eval_step, batch, EVAL_SLAB * mesh.size)
        if timing:
            stats["val_s"].append(time.perf_counter() - t0)
        if not main:
            return None
        rgb_key = "rgbs_fine" if "rgbs_fine" in out else "rgbs"
        d_key = "depths_fine" if "depths_fine" in out else "depths"
        W, H = cfg.img_wh
        pred = out[rgb_key].reshape(H, W, 3)
        gt = batch["rgbs"].reshape(H, W, 3)
        metrics = {"psnr": psnr_np(pred, gt), "ssim": ssim(pred, gt)}
        logger.log(step, metrics, prefix="val")
        if epoch % max(cfg.val.vis_freq, 1) == 0:
            from animnerf_tpu_torch.utils.vis import save_image, triptych

            panel = triptych(gt, pred, out[d_key].reshape(H, W))
            save_image(os.path.join(
                logger.dir, f"val_epoch{epoch:04d}.png"), panel)
            logger.log_image(step, "val/gt_pred_depth", panel)
        return metrics

    prof = None
    max_steps = cfg.train.max_steps
    log_every = cfg.train.get("log_every", 50)
    step = start_step
    rays_per_step = cfg.train.batch_size * cfg.train.subsamplesize**2
    last_log_step, last_log_time = step, time.time()
    metrics = {"loss": float("nan"), "psnr": float("nan")}
    first_epoch, skip = divmod(start_step, steps_per_epoch)

    for epoch in range(first_epoch, cfg.train.max_epochs):
        batches = loader.epoch(epoch)
        i = 0
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            i += 1
            if epoch == first_epoch and i <= skip:
                continue  # resumed: these steps were taken before
            if profile and main and step == start_step + 2:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if dev.type == "cuda" else [])])
                prof.start()
            t_step = time.perf_counter()
            metrics = train_step(place_batch(batch))
            if timing:
                _sync(dev)
                stats["wait_s"].append(t_step - t_wait)
                stats["step_s"].append(time.perf_counter() - t_step)
                stats["compact_count"].append(
                    metrics.get("compact_count", 0))
            if prof is not None and step == start_step + 4:
                _sync(dev)
                prof.stop()
                os.makedirs(os.path.join(logger.dir, "profile"),
                            exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    logger.dir, "profile", "trace.json"))
                prof = None
            step += 1
            if main and (step % log_every == 0 or step == 1):
                m = {k: float(v) for k, v in metrics.items()}
                # windowed rate (since the last log)
                now = time.time()
                m["rays_per_sec"] = (rays_per_step * (step - last_log_step)
                                     / max(now - last_log_time, 1e-9))
                last_log_step, last_log_time = step, now
                m["lr"] = float(cfg.train.lr) * lr_factor(step)
                logger.log(step, m)
                if timing:
                    stats["losses"].append((step, m["loss"]))
                print(f"epoch {epoch} step {step} "
                      f"loss {m['loss']:.4f} psnr {m['psnr']:.2f} "
                      f"({m['rays_per_sec']:.0f} rays/s)", flush=True)
            if step >= max_steps:
                break
        batches.close()
        # end of epoch: validation, then checkpoints on the train psnr
        m = {k: float(v) for k, v in metrics.items()}
        try:
            val_m = run_validation(epoch)
            if main:
                print(f"epoch {epoch} val psnr {val_m['psnr']:.2f} "
                      f"ssim {val_m['ssim']:.4f}", flush=True)
        except (FileNotFoundError, IndexError, KeyError) as e:
            # val data is optional (missing frames / dirs); any other
            # exception must surface
            if main:
                print(f"epoch {epoch} validation skipped: {e}", flush=True)
        t0 = time.perf_counter()
        if main:
            meta = {"epoch": epoch, "cfg": dict_flat(cfg)}
            manager.save(system_params(system), step, m, extra_meta=meta)
            # 'last' carries the full train state for resume
            save_train_state(os.path.join(ckpt_dir, "last"), system,
                             optimizer, scheduler, step, trainer.generator,
                             dict(meta, metrics=m))
        barrier(mesh)
        if timing:
            stats["save_s"].append(time.perf_counter() - t0)
        if step >= max_steps:
            break

    if main:
        logger.close()
    barrier()
    return ckpt_dir


def evaluate(cfg: CfgNode, ckpt_path: str, split: str = "test",
             save_vis: bool = False, out_dir: Optional[str] = None,
             device: DeviceLike = None,
             stats: Optional[dict] = None) -> dict:
    """Full-frame renders of a split -> the means of PSNR, SSIM and, where
    the LPIPS weights file exists, LPIPS (on the system's device).
    ``stats``, when given, collects ``frame_s``: each frame's render on
    the host clock, synchronised, and ``score_s``: its metrics. Under a
    process group every rank renders its share of each frame's rays, rank
    0 scores, prints and saves, and every rank returns its means."""
    from animnerf_tpu_torch.models.evaluator import Evaluator

    mesh = make_mesh(device=device)
    dev = mesh.device
    main = mesh.is_main
    system = build_system(cfg, dev)
    ds = _frame_dataset(cfg, split)
    system.set_body_params(load_body_params_from_dataset(
        cfg.frame_IDs, cfg.root_dir, cfg.model_type))
    check_visible(mesh, ckpt_path)
    load_params(ckpt_path, system)
    eval_step = make_sharded_eval_step(system, mesh)
    evaluator = Evaluator(device=dev) if main else None
    if stats is not None:
        stats.setdefault("frame_s", [])
        stats.setdefault("score_s", [])

    W, H = cfg.img_wh
    scores = []
    for batch in Loader(ds, batch_size=1, shuffle=False).epoch(0):
        t0 = time.perf_counter()
        out = render_frame(eval_step, batch, EVAL_SLAB * mesh.size)
        if stats is not None:
            stats["frame_s"].append(time.perf_counter() - t0)
        if not main:
            continue
        rgb_key = "rgbs_fine" if "rgbs_fine" in out else "rgbs"
        pred = out[rgb_key].reshape(H, W, 3)
        gt = batch["rgbs"].reshape(H, W, 3)
        t0 = time.perf_counter()
        s = evaluator(pred, gt)
        if stats is not None:
            stats["score_s"].append(time.perf_counter() - t0)
        scores.append(s)
        frame_id = int(batch["frame_id"][0])
        print(f"frame {frame_id}: "
              + " ".join(f"{k}={v:.4f}" for k, v in s.items()), flush=True)
        if save_vis and out_dir:
            from animnerf_tpu_torch.utils.vis import save_triptych

            d_key = "depths_fine" if "depths_fine" in out else "depths"
            os.makedirs(out_dir, exist_ok=True)
            save_triptych(os.path.join(out_dir, f"{frame_id:06d}.png"),
                          gt, pred, out[d_key].reshape(H, W))

    means = {k: float(np.mean([s[k] for s in scores]))
             for k in scores[0]} if scores else {}
    if main:
        for k, v in means.items():
            print(f"mean {k}: {v:.4f}")
    return broadcast_object(mesh, means)
