"""Anim-NeRF's training step in plain float32 PyTorch: the six loss terms
(rgb, alpha L1, the density terms on points inside and outside the body,
normal smoothness through the density's input gradient; each for the
coarse and the fine field), their gradients by autograd, and Adam with
the learning rate of its group (the body parameters at half the field's)
and poly decay by epoch.

Parameters are a dict of leaf tensors keyed as the program names its
parameters: ``scene.nerf.<layer>.weight`` / ``.bias``, the same under
``scene.nerf_fine``, and ``body_params.<key>`` (betas one row shared by
the frames, the rest a row a frame). The render runs a frame at a time
and each frame's part of the loss is backpropagated at once, so memory
holds one frame's activations; the gradient is the whole batch's.
"""

from __future__ import annotations

import torch

from reference import body, field as fld, render

NET = {"scene.nerf": "coarse", "scene.nerf_fine": "fine"}


def field_params(params: dict, net: str, arch: dict) -> dict:
    return {layer: (params[f"{net}.{layer}.weight"],
                    params[f"{net}.{layer}.bias"])
            for layer in fld.layer_shapes(arch)}


def _safe_normalize(n: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    norm = torch.sqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    return n / (norm + eps)


def _rows(d: dict, b: int) -> dict:
    return {k: v[b] for k, v in d.items()}


def loss_and_grad(params: dict, rig: body.Rig, batch: dict, noise: dict,
                  cfg: dict, quant=None) -> dict:
    """Backpropagate the batch's loss into ``params[...].grad`` (which
    must be None or zero); returns the loss terms as floats."""
    t = cfg["train"]
    arch = cfg["arch"]
    fields = [field_params(params, net, arch) for net in NET]
    frame_idx = batch["frame_idx"]
    B, R = batch["rays"].shape[:2]
    keys = body.FAMILY_KEYS[rig.model_type]
    obs = {k: params[f"body_params.{k}"] if k == "betas"
           else params[f"body_params.{k}"][frame_idx] for k in keys}
    tmpl = {k: batch[k + "_template"] for k in keys}
    ctx = body.frame(rig, obs, tmpl)
    rays = body.rays_to_root(ctx, batch["rays"])
    terms = {k: 0.0 for k in ("loss_rgb", "loss_rgb_fine", "loss_alphas",
                              "loss_alphas_fine")}
    n_rgb, n_a = float(B * R * 3), float(B * R)
    for b in range(B):
        frame = {k: ctx[k][b] for k in ("verts", "ober2cano")}
        frame["lbs_weights"] = ctx["lbs_weights"]
        out = render.render_rays(*fields, frame, rays[b], cfg,
                                 _rows(noise, b), quant)
        parts = {}
        for sfx in ("", "_fine"):
            parts["loss_rgb" + sfx] = ((out["rgbs" + sfx] - batch["rgbs"][b])
                                       ** 2).sum() / n_rgb
            parts["loss_alphas" + sfx] = (out["alphas" + sfx]
                                          - batch["alphas"][b]).abs().sum() \
                / n_a
        loss_b = sum(v * (t["lambda_alphas"] if "alphas" in k else 1.0)
                     for k, v in parts.items())
        loss_b.backward(retain_graph=True)
        for k, v in parts.items():
            terms[k] += float(v.detach())
    scale = 2.0 / cfg["n_samples"]
    pts = torch.cat([batch["fg_points"], batch["bg_points"]], 1)
    n_fg = batch["fg_points"].shape[1]
    rest = 0.0
    for fp, sfx in zip(fields, ("", "_fine")):
        sigma = fld.trunk(fp, pts.reshape(-1, 3), arch, quant)[0].reshape(
            B, -1)
        e = torch.exp(-scale * torch.relu(sigma))
        lfg, lbg = e[:, :n_fg].mean(), (1.0 - e[:, n_fg:]).mean()
        terms["loss_foreground" + sfx] = float(lfg.detach())
        terms["loss_background" + sfx] = float(lbg.detach())
        rest = rest + t["lambda_foreground"] * lfg \
            + t["lambda_background"] * lbg
    rest.backward()
    V = rig.num_verts
    for fp, sfx in zip(fields, ("", "_fine")):
        terms["loss_normals" + sfx] = 0.0
    for b in range(B):
        p = ctx["verts_template"][b].detach() + noise["normal_pts"][b] * (
            cfg["dis_threshold"] * 0.5)
        q = torch.cat([p, p + noise["normal_nbr"][b] * t["epsilon"]], 0)
        total = 0.0
        for fp, sfx in zip(fields, ("", "_fine")):
            x = q.detach().requires_grad_()
            sigma = fld.trunk(fp, x, arch, quant)[0]
            a = (1.0 - torch.exp(-0.02 * torch.relu(sigma))).sum()
            (g,) = torch.autograd.grad(a, x, create_graph=True)
            ln = ((_safe_normalize(g[:V]) - _safe_normalize(g[V:])) ** 2
                  ).sum() / float(B * V * 3)
            terms["loss_normals" + sfx] += float(ln.detach())
            total = total + t["lambda_normals"] * ln
        total.backward()
    terms["loss"] = sum(v * (t["lambda_alphas"] if "alphas" in k else
                             t["lambda_foreground"] if "foreground" in k else
                             t["lambda_background"] if "background" in k else
                             t["lambda_normals"] if "normals" in k else 1.0)
                        for k, v in terms.items())
    return terms


class Adam:
    """torch.optim.Adam's update (eps 1e-8, betas 0.9 / 0.999) with the
    body parameters at half the learning rate and poly decay by epoch."""

    def __init__(self, params: dict, cfg: dict, steps_per_epoch: int):
        self.params = params
        self.cfg = cfg
        self.spe = steps_per_epoch
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def lr(self, name: str) -> float:
        t = self.cfg["train"]
        epoch = self.t // self.spe
        decay = max(1.0 - epoch / t["max_epochs"], 0.0) ** t["poly_exp"]
        return t["lr"] * decay * (0.5 if name.startswith("body_params")
                                  else 1.0)

    @torch.no_grad()
    def step(self) -> None:
        lrs = {k: self.lr(k) for k in self.params}
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(1e-8)
            p.addcdiv_(self.m[k], denom, value=-lrs[k] / (1 - b1 ** self.t))
            p.grad = None


def follow(params0: dict, rig: body.Rig, batches: list, noises: list,
           cfg: dict, steps_per_epoch: int, quant=None) -> dict:
    """The program's first steps from the same start: the loss of each
    step, the first step's gradient by leaf, and each leaf's change over
    all of them."""
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params0.items()}
    opt = Adam(params, cfg, steps_per_epoch)
    losses, grad1 = [], None
    with render.plain_precision(tf32=quant is not None):
        for batch, noise in zip(batches, noises):
            terms = loss_and_grad(params, rig, batch, noise, cfg, quant)
            losses.append(terms["loss"])
            if grad1 is None:
                grad1 = {k: (p.grad.detach().clone() if p.grad is not None
                             else torch.zeros_like(p))
                         for k, p in params.items()}
            opt.step()
    return {"losses": losses, "grad1": grad1,
            "delta": {k: (params[k] - params0[k]).detach()
                      for k in params}}
