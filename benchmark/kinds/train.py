"""Traffic kind ``train``: the trainer's step on a pool of batches, back
to back.

The mix (``traffic/<mix>.json``) gives a pool of ``pool`` batches of
``batch`` frames, each a ``patch`` x ``patch`` ray patch of an ``img`` x
``img`` camera centred on a pixel of the posed body (the projection of a
posed vertex drawn at random), with ``fg_points`` points inside the
canonical body, ``bg_points`` around it, and the silhouette (rays within
``silhouette_m`` of a posed vertex) as the alpha target. The frames are
the configuration's training poses of one subject turning in place. The
pool is drawn from ``pool_seed``, so every run has the same work; the
run's seed orders the pool and draws the colour targets, the weights and
the noise.

``correct``: the timed trainer's first ``reference_steps`` steps in
set-up, followed by the reference from the same start. ``loss_gap``, the
largest relative gap of a step's loss; ``grad_gap``, the largest gap
between the program's and the reference's norm of a leaf's first
gradient, over the larger of that leaf's reference norm and the median
leaf's, and ``grad_gap_median``, the median leaf's such gap;
``delta_gap``, the largest such gap of a leaf's change over the steps,
and ``delta_gap_median``, the median leaf's, leaving out leaves whose
reference gradient is under a thousandth of the median leaf's (they move
by round-off alone under Adam).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from harness import avatar, check, program, rays as rays_mod, stats, traffic
from harness import trace as trace_mod
from harness.cells import Cell as Base, ref_cfg, samples_per_ray
from reference import body as ref_body
from reference import field as fld
from reference import render as ref_render
from reference import train as ref_train

NOISE = ("coarse_u", "fine_u", "sigma_c", "sigma_f", "normal_pts",
         "normal_nbr")


def train_pool(mix: dict, config: dict, rig: ref_body.Rig, seed: int,
               device) -> dict:
    """The pool of batches (tensors on ``device``) in the run's order:
    {"poses": observed params per frame, "batches": [...], "order": the
    pool indices in run order, "generator": the run's generator}."""
    P, B, S = mix["pool"], mix["batch"], mix["patch"]
    W = H = mix["img"]
    f = mix["focal"] * W
    cam = mix["cam_dist"]
    F = traffic.num_frames(config)
    rng = np.random.default_rng(mix["pool_seed"])
    obs, tmpl = traffic.draw_poses(config["model_type"], F, rng,
                                   mix["pose_scale"], turn=True)
    frame_idx = rng.integers(0, F, size=(P, B))
    vert_pick = rng.integers(0, rig.num_verts, size=(P, B))
    fg_pick = rng.integers(0, rig.num_verts, size=(P, B, mix["fg_points"]))
    fg_off = rng.normal(scale=0.005, size=(P, B, mix["fg_points"], 3))
    bg = rng.normal(scale=0.8, size=(P, B, mix["bg_points"], 3))
    obs_t = traffic.to_tensors(obs, device)
    tmpl_t = traffic.to_tensors(tmpl, device)
    with torch.no_grad(), ref_render.plain_precision():
        posed = ref_body.pose_body(rig, obs_t)["verts"]           # (F, V, 3)
        canon = ref_body.pose_body(rig, tmpl_t)["verts"][0]        # (V, 3)
    fi = torch.as_tensor(frame_idx, device=device).reshape(-1)
    vp = torch.as_tensor(vert_pick, device=device).reshape(-1)
    centres = rays_mod.project(posed[fi, vp], W, H, f, cam)
    rays = rays_mod.patch_rays(centres, S, W, H, f, cam, mix["near"],
                               mix["far"])                      # (P*B, R, 8)
    alphas = ref_render.rays_near_points(rays, posed[fi],
                                         mix["silhouette_m"])
    fg = canon[torch.as_tensor(fg_pick, device=device)] + torch.as_tensor(
        fg_off, dtype=torch.float32, device=device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=device) \
        + canon.mean(0)
    R = S * S
    rays = rays.reshape(P, B, R, 8)
    alphas = alphas.reshape(P, B, R, 1).to(torch.float32)
    fi = fi.reshape(P, B)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    order = torch.randperm(P, generator=gen, device=device).tolist()
    batches = []
    for p in order:
        b = {"frame_idx": fi[p], "rays": rays[p], "alphas": alphas[p],
             "rgbs": torch.rand((B, R, 3), generator=gen, device=device),
             "fg_points": fg[p], "bg_points": bg[p]}
        for k, v in tmpl_t.items():
            b[k + "_template"] = v.expand(B, -1).contiguous()
        batches.append(b)
    return {"poses": obs_t, "batches": batches, "order": order,
            "generator": gen}


def draw_noise(gen: torch.Generator, B: int, R: int, config: dict,
               V: int, device) -> dict:
    """One step's random numbers: stratified and importance uniforms,
    the sigma noise of both composites, the normal term's jitter."""
    Kc, Kf = config["n_samples"], config["n_importance"]

    def uni(*s):
        return torch.rand(s, generator=gen, device=device)

    def nrm(*s):
        return torch.randn(s, generator=gen, device=device)

    return {"coarse_u": uni(B, R, Kc), "fine_u": uni(B, R, Kf),
            "sigma_c": nrm(B, R, Kc), "sigma_f": nrm(B, R, Kc + Kf),
            "normal_pts": nrm(B, V, 3), "normal_nbr": nrm(B, V, 3)}


def half_batch(trainer):
    """Fault: half of the batch left out, the mean taken over the rest."""
    def step(batch, noise):
        h = batch["rays"].shape[0] // 2
        return trainer.step({k: v[:h] for k, v in batch.items()},
                            program.train_noise({k: getattr(noise, k)[:h]
                                                 for k in NOISE}))
    return step


class Cell(Base):
    kind = "train"
    faults = {"half_batch": half_batch}

    def __init__(self, run, wrap=None):
        super().__init__(run, wrap)
        c, tr = self.config, self.traffic
        self.pool = train_pool(tr, c, self.rig, run.seed, self.dev)
        self.batches = self.pool["batches"]
        self.F = traffic.num_frames(c)
        self.weights = avatar.field_weights(tr.get("avatar", {}), c,
                                            run.seed, self.dev, run.root)
        self.system = program.build_system(c, self.rig_arrays, self.weights,
                                           self.dev, self.F,
                                           self.pool["poses"])
        self.trainer = program.make_trainer(self.system,
                                            tr["steps_per_epoch"])
        self.step_fn = self.trainer.step if wrap is None else \
            wrap(self.trainer)
        self.B, self.R = tr["batch"], tr["patch"] ** 2
        self.i = 0
        self.used = []
        self.p0 = {k: v.detach().clone()
                   for k, v in self.system.named_parameters()}
        self.first = {"losses": [], "noises": [], "batches": []}
        for s in range(tr["reference_steps"]):
            b, nz = self.feed()
            d = self.step_fn(b, program.train_noise(nz))
            self.first["losses"].append(float(d["loss"]))
            self.first["noises"].append(nz)
            self.first["batches"].append(b)
            if s == 0:
                self.first["grad1"] = program.first_grads(self.trainer)
        self.first["delta"] = {k: v.detach() - self.p0[k]
                               for k, v in self.system.named_parameters()}
        self.sync()

    def feed(self):
        p = self.i % len(self.batches)
        self.i += 1
        self.used.append(p)
        return self.batches[p], draw_noise(
            self.pool["generator"], self.B, self.R, self.config,
            self.rig.num_verts, self.dev)

    def one(self):
        b, nz = self.feed()
        return self.step_fn(b, program.train_noise(nz))["loss"]

    def window(self, seconds: float) -> dict:
        first = len(self.used)
        losses = []
        t0 = time.perf_counter()
        while True:
            losses.append(self.one())
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        dt = time.perf_counter() - t0
        ok = torch.isfinite(torch.stack(losses)).cpu()
        n = len(losses)
        self.window_used = self.used[first:first + n]
        return {"seconds": dt, "count": n, "failed": int(n - ok.sum()),
                "rays": n * self.B * self.R}

    def end_to_end(self, win: dict, setup_s: float) -> dict:
        return {"setup_s": (setup_s, "s"),
                "train_rays_per_s": (stats.rate(win["rays"], win["seconds"]),
                                     "rays/s")}

    def traced(self, count: int) -> dict:
        rec = trace_mod.profile(self.one, self.one, count)
        rec["count"] = count
        return rec

    def work(self) -> dict:
        """Model FLOPs of each pool batch: the rays within dis_threshold
        of a posed vertex, times the model's samples a ray and the FLOPs
        a sample, times 3 for the forward and the backward."""
        c = self.config
        per_ray = samples_per_ray(c) * fld.flops_per_sample(c["arch"]) * 3
        poses = self.pool["poses"]
        flop = []
        with torch.no_grad(), ref_render.plain_precision():
            for b in self.batches:
                obs = {k: v if k == "betas" else v[b["frame_idx"]]
                       for k, v in poses.items()}
                tmpl = {k: b[k + "_template"] for k in poses}
                ctx = ref_body.frame(self.rig, obs, tmpl)
                rr = ref_body.rays_to_root(ctx, b["rays"])
                hit = ref_render.rays_near_points(rr, ctx["verts"],
                                                  c["dis_threshold"])
                flop.append(float(hit.sum()) * per_ray)
        return {"model_flop": sum(flop[p] for p in self.window_used)}

    def outputs(self) -> dict:
        return {k: self.first[k] for k in ("losses", "grad1", "delta")}

    def reference(self, quant=None) -> dict:
        return ref_train.follow(self.p0, self.rig, self.first["batches"],
                                self.first["noises"], ref_cfg(self.config),
                                self.traffic["steps_per_epoch"], quant)

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """prog / ref: {"losses": [float], "grad1": {leaf: tensor},
        "delta": {leaf: tensor}}."""
        gaps = [abs(p - r) / abs(r) for p, r in
                zip(prog["losses"], ref["losses"])]
        gp, gr = check.norms(prog["grad1"]), check.norms(ref["grad1"])
        keys = sorted(gr)
        med_g = statistics.median(gr[k] for k in keys)
        moved = [k for k in keys if gr[k] >= check.MOVE_SHARE * med_g]
        dp, dr = check.norms(prog["delta"]), check.norms(ref["delta"])
        g = check.leaf_gaps(gp, gr, keys)
        d = check.leaf_gaps(dp, dr, moved)
        return {"loss_gap": max(gaps),
                "grad_gap": max(g.values()),
                "grad_gap_median": statistics.median(g.values()),
                "delta_gap": max(d.values()),
                "delta_gap_median": statistics.median(d.values())}

    def diagnostics(self, prog: dict, ref: dict) -> dict:
        """The three leaves with the widest gradient-norm gaps and each
        step's loss gap (what PERF.md's look at the numbers read)."""
        gp, gr = check.norms(prog["grad1"]), check.norms(ref["grad1"])
        g = check.leaf_gaps(gp, gr, sorted(gr))
        top = sorted(g, key=lambda k: -g[k])[:3]
        return {"worst_grad_leaves": [[k, g[k], gr[k]] for k in top],
                "step_loss_gaps": [abs(p - r) / abs(r) for p, r in
                                   zip(prog["losses"], ref["losses"])]}
