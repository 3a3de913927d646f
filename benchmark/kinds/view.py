"""Traffic kind ``view``: a turntable of one posed avatar through
``Renderer.render_stream``, one view after another in a closed loop as
the novel-view CLI renders them.

The mix (``traffic/<mix>.json``) gives a ``views``-view turntable at
``img`` x ``img`` (focal ``focal`` x ``img`` from ``cam_dist``), the
pre-pass, and the avatar: a trained field and its pose from a checkpoint
directory, or seeded weights and a pose drawn from ``pose_seed``. The
run's seed picks the first view and the ``check_views`` views whose
images are checked. ``pose(view)`` gives each view's body; a kind that
moves the body from view to view overrides it.

``correct``: the checked views of the window, rendered again by the
reference. ``rgb_rms`` and ``alpha_rms``, the root mean square of the
image's and mask's difference over the pixels, and ``depth_rms`` over
the pixels the reference's mask covers to 0.99 or more (at the
silhouette's edge depth jumps between the body and the far plane, which
``alpha_rms`` already holds); the largest over the views.
"""

from __future__ import annotations

import math
import os
import pickle
import time

import numpy as np
import torch

from harness import avatar, program, rays as rays_mod, stats, traffic
from harness import trace as trace_mod
from harness.cells import Cell as Base, ref_cfg, samples_per_ray
from reference import body as ref_body
from reference import field as fld
from reference import render as ref_render
from reference import train as ref_train


def view_stream(mix: dict, config: dict, seed: int, root: str) -> dict:
    """The turntable: world rays (R, 8) numpy, the body and template
    params ((1, dim) numpy), the view sequence and the views to check."""
    W = H = mix["img"]
    rays = rays_mod.camera_rays(W, H, mix["focal"] * W, mix["cam_dist"],
                                mix["near"], mix["far"])
    av = mix["avatar"]
    if "pose_file" in av:
        def load(name):
            with open(os.path.join(root, av["path"], name), "rb") as fh:
                d = pickle.load(fh)
            return {k: np.asarray(d[k], np.float32).reshape(1, -1)
                    for k in traffic.PARAM_DIMS[config["model_type"]]}
        bp, tmpl = load(av["pose_file"]), load(av["template_file"])
    else:
        bp, tmpl = traffic.draw_poses(config["model_type"], 1,
                                      np.random.default_rng(av["pose_seed"]),
                                      mix["pose_scale"], turn=False)
        bp["transl"][:] = 0.0
    n = mix["views"]
    rng = np.random.default_rng(seed)
    first = int(rng.integers(0, n))
    check = sorted(int(v) for v in rng.choice(n, mix["check_views"],
                                              replace=False))
    return {"rays": rays, "body_params": bp, "body_tmpl": tmpl,
            "first": first, "n_views": n, "check": check,
            "img_wh": (W, H)}


def rms_numbers(prog: list, ref: list) -> dict:
    """prog / ref: [(img (H, W, 3), mask (H, W), depth (H, W))] per view."""
    out = {"rgb_rms": 0.0, "alpha_rms": 0.0, "depth_rms": 0.0}
    for p, r in zip(prog, ref):
        opaque = np.asarray(r[1]) >= 0.99
        for name, a, b in zip(out, p, r):
            d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
            if name == "depth_rms":
                d = d[opaque]
            if d.size:
                out[name] = max(out[name],
                                math.sqrt(float(np.mean(d * d))))
    return out


class Cell(Base):
    kind = "view"

    def __init__(self, run, wrap=None):
        super().__init__(run, wrap)
        c, tr = self.config, self.traffic
        self.st = view_stream(tr, c, run.seed, run.root)
        self.weights = avatar.field_weights(tr["avatar"], c, run.seed,
                                            self.dev, run.root)
        self.system = program.build_system(c, self.rig_arrays, self.weights,
                                           self.dev)
        self.renderer = program.make_renderer(self.system, tr["prepass"])
        if wrap is not None:
            self.renderer.render_frame = wrap(self.renderer.render_frame)
        self.angle = self.st["first"]
        self.angles = []
        self.stream = self.renderer.render_stream(self._frames())
        self.kept = {}
        self.counts = []
        self.trace_angles = []
        for _ in range(tr["warmup_views"]):
            self.one()
        self.kept = {}

    def pose(self, view: int) -> tuple:
        """(body params, template params) of a view, {key: (1, dim)}
        numpy: the one pose of the turntable."""
        return self.st["body_params"], self.st["body_tmpl"]

    def _frames(self):
        st = self.st
        while True:
            a = self.angle
            self.angle = (self.angle + 1) % st["n_views"]
            self.angles.append(a)
            bp, tmpl = self.pose(a)
            yield {"body_params": bp, "body_tmpl": tmpl, "rays": st["rays"],
                   "P": rays_mod.turntable(a, st["n_views"]),
                   "img_wh": st["img_wh"]}

    def one(self):
        img, mask, depth = next(self.stream)
        a = self.angles[-1]
        self.counts.append(tuple(self.renderer.last_counts))
        if a in self.st["check"] and a not in self.kept:
            self.kept[a] = (img.copy(), mask.copy(), depth.copy())
        return img, mask, depth

    def window(self, seconds: float) -> dict:
        first = len(self.angles)
        lat, failed = [], 0
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            try:
                img, mask, depth = self.one()
                if not (np.isfinite(img).all() and np.isfinite(mask).all()
                        and np.isfinite(depth).all()):
                    failed += 1
            except RuntimeError:
                failed += 1  # a failed view ends the stream: start anew
                self.stream = self.renderer.render_stream(self._frames())
            lat.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        self.window_angles = self.angles[first:first + len(lat)]
        return {"seconds": dt, "count": len(lat), "failed": failed,
                "latencies": lat}

    def end_to_end(self, win: dict, setup_s: float) -> dict:
        return {"setup_s": (setup_s, "s"),
                "view_fps": (stats.rate(win["count"], win["seconds"]),
                             "views/s"),
                "view_p95_ms": (stats.percentile(win["latencies"], 95) * 1e3,
                                "ms")}

    def traced(self, count: int) -> dict:
        n0 = len(self.counts)
        rec = trace_mod.profile(self.one, self.one, count)
        rec["count"] = count
        # the device pass's calls, after its warm call
        rec["view_counts"] = self.counts[n0 + 1:n0 + 1 + count]
        rec["view_angles"] = self.angles[n0 + 1:n0 + 1 + count]
        self.trace_angles = rec["view_angles"]
        return rec

    def _root_rays(self, view: int):
        """The view's rays in the root frame, turned by the turntable, and
        the frame's geometry, by the reference's body model."""
        st = self.st
        bp, tmpl = self.pose(view)
        ctx = ref_body.frame(self.rig, traffic.to_tensors(bp, self.dev),
                             traffic.to_tensors(tmpl, self.dev))
        rr = ref_body.rays_to_root(ctx, torch.as_tensor(
            st["rays"], device=self.dev)[None])
        P = torch.as_tensor(rays_mod.turntable(view, st["n_views"]),
                            device=self.dev)
        rr = torch.cat([rr[..., 0:3] @ P[:3, :3].T + P[:3, 3],
                        rr[..., 3:6] @ P[:3, :3].T, rr[..., 6:8]], -1)
        return rr, ctx

    def work(self) -> dict:
        """Model FLOPs of each view rendered: the rays within
        dis_threshold of a posed vertex, times the model's samples a ray
        and the FLOPs a sample."""
        c = self.config
        spr = samples_per_ray(c)
        hits = {}
        with torch.no_grad(), ref_render.plain_precision():
            for a in set(self.window_angles) | set(self.trace_angles):
                rr, ctx = self._root_rays(a)
                hits[a] = float(ref_render.rays_near_points(
                    rr, ctx["verts"], c["dis_threshold"]).sum())
        fps = fld.flops_per_sample(c["arch"])
        return {"model_flop": sum(hits[a] for a in self.window_angles)
                * spr * fps,
                "trace_model_samples": sum(hits[a] for a in
                                           self.trace_angles) * spr}

    def outputs(self):
        # a check view that the window did not reach is rendered now
        for a in self.st["check"]:
            if a not in self.kept:
                self.angle = a
                self.one()
        return [self.kept[a] for a in self.st["check"]]

    def reference(self, quant=None) -> list:
        c = self.config
        W, H = self.st["img_wh"]
        out = []
        with torch.no_grad(), ref_render.plain_precision(
                tf32=quant is not None):
            for a in self.st["check"]:
                rr, ctx = self._root_rays(a)
                frame = {"verts": ctx["verts"][0],
                         "ober2cano": ctx["ober2cano"][0],
                         "lbs_weights": ctx["lbs_weights"]}
                rr = rr[0]
                hit = torch.nonzero(ref_render.rays_near_points(
                    rr[None], ctx["verts"], c["dis_threshold"])[0])[:, 0]
                img = torch.ones(rr.shape[0], 3, device=self.dev)
                mask = torch.zeros(rr.shape[0], device=self.dev)
                depth = rr[:, 7].clone()
                pc = ref_train.field_params(self.weights, "scene.nerf",
                                            c["arch"])
                pf = ref_train.field_params(self.weights, "scene.nerf_fine",
                                            c["arch"])
                blk = self.traffic["reference_block"]
                for s in range(0, hit.shape[0], blk):
                    i = hit[s:s + blk]
                    o = ref_render.render_rays(pc, pf, frame, rr[i],
                                               ref_cfg(c), None, quant)
                    img[i] = o["rgbs_fine"]
                    mask[i] = o["alphas_fine"][:, 0]
                    depth[i] = o["depths_fine"][:, 0]
                out.append((img.reshape(H, W, 3).cpu().numpy(),
                            mask.reshape(H, W).cpu().numpy(),
                            depth.reshape(H, W).cpu().numpy()))
        return out

    compare = staticmethod(rms_numbers)
