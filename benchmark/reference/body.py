"""Plain SMPL / SMPL-X skinning and the per-frame geometry of Anim-NeRF.

Float32 PyTorch, written from the published model (Loper et al. 2015,
Pavlakos et al. 2019) and the Anim-NeRF paper's unpose transform, with
the joints walked one by one. It reads only the rig arrays, body
parameters and rays that the benchmark makes; it imports nothing of the
program. Callers turn TF32 off (``reference.render.plain_precision``).
"""

from __future__ import annotations

import torch

# keys of the body parameters by family, in the order the pose is built
FAMILY_KEYS = {
    "smpl": ("betas", "global_orient", "body_pose", "transl"),
    "smplx": ("betas", "global_orient", "body_pose", "transl",
              "left_hand_pose", "right_hand_pose", "jaw_pose", "expression"),
}


class Rig:
    """A body model's arrays as float32 tensors on one device."""

    def __init__(self, arrays: dict, model_type: str, device):
        def t(k):
            a = arrays.get(k)
            return None if a is None else torch.as_tensor(
                a, dtype=torch.float32, device=device).clone()

        self.model_type = model_type
        self.v_template = t("v_template")
        self.shapedirs = t("shapedirs")
        self.posedirs = t("posedirs")
        self.J_regressor = t("J_regressor")
        self.lbs_weights = t("lbs_weights")
        self.parents = [int(p) for p in arrays["parents"]]
        self.hand_l = t("hand_components_l")
        self.hand_r = t("hand_components_r")
        self.mean_l = t("hand_mean_l")
        self.mean_r = t("hand_mean_r")

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3), with SMPL's +1e-8 in the norm."""
    angle = torch.linalg.norm(r + 1e-8, dim=-1, keepdim=True)
    a = r / angle
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    z = torch.zeros_like(a[..., 0])
    K = torch.stack([torch.stack([z, -a[..., 2], a[..., 1]], -1),
                     torch.stack([a[..., 2], z, -a[..., 0]], -1),
                     torch.stack([-a[..., 1], a[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def _full_pose(rig: Rig, p: dict, B: int) -> torch.Tensor:
    parts = [p["global_orient"], p["body_pose"]]
    if rig.model_type == "smplx":
        zero = p["global_orient"].new_zeros(B, 3)
        parts += [p.get("jaw_pose", zero), zero, zero,
                  p["left_hand_pose"] @ rig.hand_l + rig.mean_l,
                  p["right_hand_pose"] @ rig.hand_r + rig.mean_r]
    return torch.cat(parts, dim=1).reshape(B, -1, 3)


def pose_body(rig: Rig, p: dict) -> dict:
    """Body parameters {key: (B, dim)} -> verts (B, V, 3), joint
    transforms A (B, J, 4, 4), vertex transforms T (B, V, 4, 4) and the
    shape and pose offsets (B, V, 3); ``transl`` folded into verts, A and
    T as Anim-NeRF does."""
    B = p["global_orient"].shape[0]
    betas = p["betas"].expand(B, -1)
    dirs = rig.shapedirs
    expr = p.get("expression")
    if rig.model_type == "smplx" and expr is not None \
            and dirs.shape[-1] >= betas.shape[-1] + expr.shape[-1]:
        betas = torch.cat([betas, expr], dim=-1)
        dirs = dirs[..., :betas.shape[-1]]
    shape_off = torch.einsum("bl,vkl->bvk", betas, dirs)
    v_shaped = rig.v_template[None] + shape_off
    j_rest = torch.einsum("jv,bvk->bjk", rig.J_regressor, v_shaped)
    R = rodrigues(_full_pose(rig, p, B))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    pose_off = ((R[:, 1:] - eye).reshape(B, -1) @ rig.posedirs).reshape(
        B, -1, 3)
    v_posed = v_shaped + pose_off
    world = []
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=R.device).expand(
        B, 1, 4)
    for j, parent in enumerate(rig.parents):
        rel = j_rest[:, j] if parent < 0 else j_rest[:, j] - j_rest[:, parent]
        local = torch.cat([torch.cat([R[:, j], rel[..., None]], -1), bottom],
                          -2)
        world.append(local if parent < 0 else world[parent] @ local)
    world = torch.stack(world, dim=1)                       # (B, J, 4, 4)
    t_fix = world[..., :3, 3] - torch.einsum("bjmn,bjn->bjm",
                                             world[..., :3, :3], j_rest)
    A = torch.cat([torch.cat([world[..., :3, :3], t_fix[..., None]], -1),
                   world[..., 3:, :]], -2)
    T = torch.einsum("vj,bjmn->bvmn", rig.lbs_weights, A)
    verts = torch.einsum("bvmn,bvn->bvm", T[..., :3, :3], v_posed) \
        + T[..., :3, 3]
    transl = p.get("transl")
    if transl is not None:
        verts = verts + transl[:, None]
        shift = torch.zeros(B, 1, 4, 4, device=R.device)
        shift[:, 0, :3, 3] = transl
        A = A + shift
        T = T + shift
    return {"verts": verts, "A": A, "T": T, "shape_off": shape_off,
            "pose_off": pose_off}


def affine_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) affine transforms."""
    R_inv = torch.linalg.inv(M[..., :3, :3])
    t = -torch.einsum("...mn,...n->...m", R_inv, M[..., :3, 3])
    return torch.cat([torch.cat([R_inv, t[..., None]], -1), M[..., 3:, :]],
                     -2)


def apply(M: torch.Tensor, x: torch.Tensor, direction: bool = False):
    y = torch.einsum("...mn,...n->...m", M[..., :3, :3], x)
    return y if direction else y + M[..., :3, 3]


def frame(rig: Rig, obs: dict, tmpl: dict) -> dict:
    """Observed and template parameters -> the frame in the root joint's
    coordinates: posed verts (B, V, 3), the world-to-root transform
    (B, 4, 4), each vertex's observed-to-canonical transform (B, V, 4, 4)
    with the blend-shape offsets undone, and the template verts."""
    o = pose_body(rig, obs)
    t = pose_body(rig, tmpl)
    root_inv = affine_inverse(o["A"][:, 0])
    verts = apply(root_inv[:, None], o["verts"])
    inv = affine_inverse(root_inv[:, None] @ o["T"])
    delta = (t["shape_off"] - o["shape_off"]) + (t["pose_off"] - o["pose_off"])
    inv = torch.cat([torch.cat([inv[..., :3, :3],
                                inv[..., :3, 3:] + delta[..., None]], -1),
                     inv[..., 3:, :]], -2)
    return {"verts": verts, "root_inv": root_inv, "ober2cano": t["T"] @ inv,
            "verts_template": t["verts"], "lbs_weights": rig.lbs_weights}


def rays_to_root(ctx: dict, rays: torch.Tensor) -> torch.Tensor:
    """(B, R, 8) world rays -> root frame, near and far tightened to the
    root's distance from the camera -/+ 1 m."""
    M = ctx["root_inv"][:, None]
    o = apply(M, rays[..., 0:3])
    d = apply(M, rays[..., 3:6], direction=True)
    dist = torch.linalg.norm(o, dim=-1, keepdim=True)
    near = torch.maximum(rays[..., 6:7], dist - 1.0)
    far = torch.minimum(rays[..., 7:8], dist + 1.0)
    return torch.cat([o, d, near, far], dim=-1)
