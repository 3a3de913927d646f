"""Top-k nearest vertices: three CUDA kernels, their plain versions and the
dispatcher between them.

Counterpart of ``animnerf_tpu/ops/knn_pallas.py::knn_pallas`` with
``transposed_out=True``: points (B, N, 3) and the Morton-sorted vertices
(B, V, 3) -> dists (B, k, N) ascending and idx (B, k, N) int32, for any k
in 1..V (the JAX package's ``k_neigh``). Kernels 8 and 9 run two designs.
Up to ``PACKED_WIDE_ABOVE`` / ``EXACT_WIDE_ABOVE`` (16 / 23) neighbours a
thread sweeps its points with the k slots in its registers, one
instantiation per K (the "sweep" route). Above, and for any k when asked,
a warp owns a point and k is a run-time bound (the "wide" route,
``knn_packed_wide`` / ``knn_exact_wide`` on ``csrc/knn_wide.cuh``): the
lanes split each vertex
tile, the tiles are visited nearest first by a bound on their box and
the sweep stops where that bound passes the k-th neighbour, a vote sends
the pairs below the point's filter to a buffer and a bitonic fold keeps
the k smallest. Kernel 8 may visit the tiles in any order because its
keys are unique; kernel 9 takes a point's output from that pass when its
k + 1 nearest d2 strictly ascend (the TPU rule then has no choice to
make) and runs the rule's index-order sweep, culled per point and merging
a tile list at a time, for the points with ties. The lists sit in
registers up to ``WIDE_CAP`` = 128 neighbours; above, each kernel's
global-memory version takes k (one thread a point, slow but exact). Both
designs give the plain versions' output bit for bit, so the thresholds
only pick the faster one (see the sources' notes and ``PERF.md``).
``knn`` picks the kernel
as ``knn_pallas`` does (``knn_pallas.py:554-607``) at its default
512-vertex tiles, under which "padded V <= 8192" is "V <= 8192":

- ``packed`` and V <= 8192, k == 4: ``knn_top4`` (kernel 1, the tournament
  kernel's counterpart, optional ``tile_skip``);
- ``packed`` and V <= 8192, k != 4: ``knn_packed`` (kernel 8, the
  extract-min kernel's counterpart; no tile skip, as in JAX);
- otherwise (SMPL-X's V=10475, or ``packed=False``): ``knn_exact``
  (kernel 9, ``_knn_kernel``'s counterpart), with its ``cull``.

``ANIMNERF_KNN_PACKED=0`` in the environment turns ``packed`` off for
every call, as the JAX package passes ``packed=False`` to ``knn_pallas``
from every caller under it (``ops/knn.py:105``, ``models/warp.py:382``,
``:478``). Its ``ANIMNERF_KNN_TILE_N`` / ``_TILE_V`` size the TPU
kernels' VMEM tiles and have no meaning for these kernels.

Packed keys (``knn_top4``, ``knn_packed``):

Each candidate's key is ``(bits(max(d2, 0)) & ~0x1FFF) | vertex_index``
with d2 in the dot form ``pp + (m2z*pz + (m2y*py + (m2x*px + vq)))``; the
k smallest keys win (ties go to the smaller index) and the distances are
``sqrt`` of the quantized d2 (13 low mantissa bits dropped, <= 2^-10
relative on d2). Both versions compute every key bit for bit as the TPU
kernels do; the vertex index field limits V to 8192. Keys are unique, so
kernel 1's tournament, kernel 8's extract-min passes and a plain top-k
select the same keys: at k=4 the two kernels agree bit for bit. On the
card both sweep vertex rows that ``vertex_rows`` builds once per call
(``csrc/knn_sweep.cuh``): (m2x, m2y, m2z, vq) in a visiting order, padded
to whole ``TILE_V`` tiles with rows whose key sorts above every real one.

Exact (``knn_exact``): d2 = ((vx-px)^2 + (vy-py)^2) + (vz-pz)^2 with every
operation rounded on its own, as ``_knn_kernel`` computes it, and the TPU
kernel's top-k rule (``tile_slots_topk``): per 512-vertex tile its k
smallest (d2, index) pairs, each replacing the first slot that holds the
slots' maximum when strictly smaller, then its sorting network. Where
distinct vertices tie exactly this keeps and orders them as the TPU
kernel does. Any V >= k. On the card the kernel sweeps vertex rows and
per-tile and per-sub-tile AABBs that ``exact_rows`` builds once per call
(``csrc/knn_exact.cu``). ``_knn_kernel``'s ``cull`` is ported and on in
``knn``: a warp skips a tile, or a 64-vertex sub-tile, whose box lies
farther from every one of its points than that point's current slot
maximum (or tile list's K-th entry), when the tile's turn comes in index
order; the output is the same with or without it, ties included.

The all-far skip (``far_skip`` = dis_threshold > 0, the TPU kernels'
``far2``; ``AnimNeRFConfig.knn_far_skip`` turns it on), in all three. As
the TPU kernels' code does it (``knn_pallas.py:69-81, 126-135, 206-216,
246-257, 336-345, 437-445``), at ``knn_pallas``'s default tiles: point n
of a batch element belongs to group n // 1024 (``FAR_GROUP``; the last
group padded with points at the origin, which take part in its minimum);
each point's bound g_lb2 is the minimum over the 512-vertex tiles of the
squared distance to the tile's box of real vertices, ((0 + gx*gx) + gy*gy)
+ gz*gz with gap = max(max(lo - p, p - hi), 0), each operation rounded on
its own; a group whose smallest bound exceeds far2 = float32(thr ** 2)
(squared in double, rounded once) skips the sweep. Its points get index 0
in every slot and the distance sqrt(g_lb2) (exact kernel) or the square
root of the bound's key rounded up one quantum, ((bits(g_lb2) & ~0x1FFF)
+ 0x2000) & ~0x1FFF (packed kernels): not the true distance to vertex 0
that ``knn_pallas``'s docstring names. Each exceeds dis_threshold, so the
warp marks the point invalid, its sigma becomes the outside-shell fill
and the render is unchanged. On the card a far pass (``csrc/knn_far.cu``)
decides the groups and writes the skipped points' outputs, and the sweep
returns at once from a block of a skipped group; with ``tile_skip`` the
all-far test comes first. The plain versions sweep only the points of
the groups kept.
"""

from __future__ import annotations

import os

import torch

from animnerf_tpu_torch.ops import _build

K = 4  # knn_top4's k
KEY_MASK = ~0x1FFF
MAX_VERTS = 8192
TILE_V = 256  # the sweep's staged vertex tile (csrc/knn_sweep.cuh)
TILE_BITS = 8
SLOT_TILE = 512  # the TPU kernels' vertex tile, which the top-k rule follows
SUB_TILE = 64  # the exact kernel's sub-tile boxes (csrc/knn_exact.cu)
EXACT_MAX_VERTS = 2**31 - SLOT_TILE  # the padded count fits an int
FAR_GROUP = 1024  # the all-far skip's point group (knn_pallas's tile_n)
# the k above which kernels 8 and 9 run their warp-per-point kernels
# (C entries animnerf_knn_packed_wide / animnerf_knn_exact_wide, which take
# any k); up to it, and only there, the per-K instantiations. Both routes
# were timed at k = 17, 24 and 32 on two shapes a kernel (PERF.md §6,
# H100 80GB HBM3 at 700 W): kernel 8's warp-per-point kernel was the
# faster at all three on both (random-order points, the training batch),
# kernel 9's at 24 and 32 on both (random-order, Morton-ordered points)
# but not at 17 on Morton-ordered points (2.68 against 1.95 ms); the
# instantiations above the thresholds went. chip_smoke.py's "knn_routes"
# line times both routes on those shapes at the boundary.
PACKED_WIDE_ABOVE = 16
EXACT_WIDE_ABOVE = 23
WIDE_CAP = 128  # knn_wide::CAP: the slot lists' registers; above, k in memory
ROUTES = (None, "sweep", "wide")
_PAD_KEY = (0x7F800000 << 32) | 0x7FFFFFFF  # d2 = +inf: never merged


def check_k(k: int) -> None:
    """k >= 1 (each caller also needs V >= k)."""
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def check_points_verts(points: torch.Tensor, verts: torch.Tensor,
                       min_verts: int = K,
                       max_verts: int = MAX_VERTS) -> None:
    """float32 (B, N, 3) points and (B, V, 3) verts, min_verts <= V <=
    max_verts, or raise."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    if verts.dim() != 3 or verts.shape[-1] != 3 \
            or verts.shape[0] != points.shape[0]:
        raise ValueError(f"verts must be (B, V, 3), got {tuple(verts.shape)}")
    if points.dtype != torch.float32 or verts.dtype != torch.float32:
        raise ValueError("kNN takes float32 points and vertices")
    if not min_verts <= verts.shape[1] <= max_verts:
        raise ValueError(f"needs {min_verts} <= V <= {max_verts}, "
                         f"got V={verts.shape[1]}")


def padded_count(V: int) -> int:
    """V rounded up to whole vertex tiles (the sweep's row count)."""
    return -(-V // TILE_V) * TILE_V


def visit_order(V: int, stratified: bool, device=None) -> torch.Tensor:
    """(Vp,) int32: the vertex index the sweep visits at each position of
    the cloud padded to whole tiles (indices >= V are padding). Rows are
    bit-reversed within a tile; ``stratified`` interleaves the tiles
    (position j * n_tiles + t holds row bitrev(j) of tile t), so that each
    staged tile samples the whole cloud; otherwise the tiles stay in index
    order (the tile skip's Morton tiles). As ``knn_sweep::visit_index``."""
    Vp = padded_count(V)
    nt = Vp // TILE_V
    pos = torch.arange(Vp, device=device)
    t, j = (pos % nt, pos // nt) if stratified else (pos // TILE_V,
                                                       pos % TILE_V)
    rev = torch.zeros_like(j)
    for bit in range(TILE_BITS):
        rev |= ((j >> bit) & 1) << (TILE_BITS - 1 - bit)
    return (t * TILE_V + rev).to(torch.int32)


def vertex_rows(verts: torch.Tensor, stratified: bool = True):
    """(B, V, 3) verts -> the rows the packed kernels sweep, (B, Vp, 4)
    float32 (-2vx, -2vy, -2vz, |v|^2) in ``visit_order``, (0, 0, 0, +inf)
    at padding positions, and that order (Vp,) int32: the rows kernel in
    ``csrc/knn.cu`` on CUDA tensors, ``vertex_rows_plain`` on CPU
    tensors."""
    check_points_verts(verts, verts, min_verts=1)
    if verts.device.type == "cpu":
        return vertex_rows_plain(verts, stratified)
    verts = verts.detach().contiguous()
    _build.check_cuda("vertex_rows", verts)
    B, V, _ = verts.shape
    Vp = padded_count(V)
    rows = torch.empty((B, Vp, 4), dtype=torch.float32, device=verts.device)
    order = torch.empty(Vp, dtype=torch.int32, device=verts.device)
    _build.kernel_library().call(
        "animnerf_knn_rows", verts.data_ptr(), rows.data_ptr(),
        order.data_ptr(), B, V, Vp, int(stratified), _build.stream_of(verts))
    return rows, order


def vertex_rows_plain(verts: torch.Tensor, stratified: bool = True):
    """``vertex_rows`` in plain torch: every product and sum its own
    operation, as ``knn_keys::vertex_row`` rounds them."""
    B, V, _ = verts.shape
    order = visit_order(V, stratified, verts.device)
    v = verts.detach()[:, order.clamp(max=V - 1).long()]     # (B, Vp, 3)
    vx, vy, vz = v.unbind(-1)
    vq = (vx * vx + vy * vy) + vz * vz
    rows = torch.stack([-(vx + vx), -(vy + vy), -(vz + vz), vq], dim=-1)
    rows[:, order >= V] = torch.tensor([0.0, 0.0, 0.0, float("inf")],
                                       device=verts.device)
    return rows.contiguous(), order


def tile_boxes(verts: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) -> (B, ceil(V / TILE_V), 8) per-tile AABBs [lo xyz, hi xyz,
    0, 0] of the kernel's vertex tiles (the last tile holds only real
    vertices)."""
    B, V, _ = verts.shape
    nt = -(-V // TILE_V)
    pad = nt * TILE_V - V
    last = verts[:, -1:].expand(B, pad, 3)  # repeats a real vertex
    vt = torch.cat([verts, last], dim=1).reshape(B, nt, TILE_V, 3)
    return torch.cat([vt.amin(dim=2), vt.amax(dim=2),
                      verts.new_zeros(B, nt, 2)], dim=-1).contiguous()


def _check_stats(stats, points: torch.Tensor) -> None:
    if stats is not None and (stats.dtype != torch.int64
                              or stats.numel() != 2
                              or stats.device != points.device):
        raise ValueError("stats must be an int64 tensor of 2 on the device")


def _outputs(points: torch.Tensor, k: int):
    B, N, _ = points.shape
    return (torch.empty((B, k, N), dtype=torch.float32, device=points.device),
            torch.empty((B, k, N), dtype=torch.int32, device=points.device))


def knn_top4(points: torch.Tensor, verts: torch.Tensor,
             tile_skip: bool = False, stats: torch.Tensor = None,
             far_skip: float = 0.0):
    """Kernel on CUDA tensors, plain version on CPU tensors (which ignores
    ``tile_skip``: the output is the same either way). ``tile_skip`` lets a
    warp skip vertex tiles that cannot hold any of its points' top-4 (exact;
    pays when the points are Morton-ordered). ``stats``: an optional int64
    CUDA tensor of 2 the kernel adds its warp-tile [swept, skipped] counts
    to. ``far_skip`` > 0: the all-far skip at that threshold (the module
    docstring), the far pass first."""
    check_points_verts(points, verts)
    if points.device.type == "cpu":
        return knn_top4_plain(points, verts, far_skip=far_skip)
    points = points.detach().contiguous()
    verts = verts.detach().contiguous()
    _build.check_cuda("knn_top4", points, verts)
    B, N, _ = points.shape
    V = verts.shape[1]
    d, i = _outputs(points, K)
    if N == 0:
        return d, i
    _check_stats(stats, points)
    flags = _far_pass(points, verts, far_skip, d, i, packed=True)
    # the tile skip sweeps the Morton tiles its boxes bound
    rows, order = vertex_rows(verts, stratified=not tile_skip)
    vbox = tile_boxes(verts) if tile_skip else None
    _build.kernel_library().call(
        "animnerf_knn_top4", points.data_ptr(), rows.data_ptr(),
        order.data_ptr(), vbox.data_ptr() if tile_skip else None,
        int(bool(tile_skip)),
        stats.data_ptr() if stats is not None else None,
        flags.data_ptr() if flags is not None else None, d.data_ptr(),
        i.data_ptr(), B, N, V, rows.shape[1], _build.stream_of(points))
    _build.LAUNCHES["knn"] += 1
    if tile_skip:
        _build.LAUNCHES["knn_tile_skip"] += 1
    return d, i


def knn_top4_plain(points: torch.Tensor, verts: torch.Tensor,
                   max_elems: int = 1 << 24, far_skip: float = 0.0):
    """``knn_packed_plain`` at k=4."""
    return knn_packed_plain(points, verts, K, max_elems, far_skip)


def _route(route, k: int, wide_above: int) -> str:
    """The kernel a wrapper launches: "wide" (the warp-per-point kernel)
    above wide_above neighbours or when asked, else "sweep" (the per-K
    instantiations, which end at wide_above)."""
    if route not in ROUTES or (route == "sweep" and k > wide_above):
        raise ValueError(f"route {route!r} does not take k={k}")
    return route or ("wide" if k > wide_above else "sweep")


def knn_packed(points: torch.Tensor, verts: torch.Tensor, k: int,
               far_skip: float = 0.0, route: str = None,
               stats: torch.Tensor = None):
    """The packed-key top-k, any k in 1..V (kernel 8): kernel on CUDA
    tensors, plain version on CPU tensors. At k=4 it selects what
    ``knn_top4`` selects, bit for bit. ``far_skip`` > 0: the all-far skip
    at that threshold, the far pass first. ``route``: None picks the
    kernel by k (``PACKED_WIDE_ABOVE``); "sweep" or "wide" asks for one
    (the output is the same). ``stats`` (the wide route up to
    ``WIDE_CAP``): an optional int64 CUDA tensor of 2 the kernel adds each
    point's real (point, vertex) pairs [swept, skipped] to."""
    check_k(k)
    check_points_verts(points, verts, min_verts=k)
    route = _route(route, k, PACKED_WIDE_ABOVE)
    if stats is not None and route != "wide":
        raise ValueError("stats: only the wide route counts pairs")
    if points.device.type == "cpu":
        return knn_packed_plain(points, verts, k, far_skip=far_skip)
    points = points.detach().contiguous()
    verts = verts.detach().contiguous()
    _build.check_cuda("knn_packed", points, verts)
    B, N, _ = points.shape
    d, i = _outputs(points, k)
    if N == 0:
        return d, i
    flags = _far_pass(points, verts, far_skip, d, i, packed=True)
    fp = flags.data_ptr() if flags is not None else None
    if route == "wide":
        # up to the cap, Morton tiles swept nearest first; above, the
        # global-memory version on the stratified rows (every staged tile
        # samples the whole cloud, so its k-th key tightens early)
        _check_stats(stats, points)
        regs = k <= WIDE_CAP
        rows, order = vertex_rows(verts, stratified=not regs)
        vbox = tile_boxes(verts) if regs else None
        _build.kernel_library().call(
            "animnerf_knn_packed_wide", points.data_ptr(), rows.data_ptr(),
            order.data_ptr(), vbox.data_ptr() if regs else None,
            stats.data_ptr() if stats is not None else None, fp,
            d.data_ptr(), i.data_ptr(), B, N, verts.shape[1], rows.shape[1],
            k, _build.stream_of(points))
        _build.LAUNCHES["knn_packed_wide"] += 1
    else:
        rows, order = vertex_rows(verts)
        _build.kernel_library().call(
            "animnerf_knn_packed", points.data_ptr(), rows.data_ptr(),
            order.data_ptr(), fp, d.data_ptr(), i.data_ptr(), B, N,
            verts.shape[1], rows.shape[1], k, _build.stream_of(points))
    _build.LAUNCHES["knn_packed"] += 1
    return d, i


def knn_packed_plain(points: torch.Tensor, verts: torch.Tensor, k: int,
                     max_elems: int = 1 << 24, far_skip: float = 0.0):
    """The packed keys in chunks over N, so the (chunk x V) key matrix
    stays below ``max_elems``; then an int top-k (smallest k, sorted).
    ``far_skip`` > 0: only the points of the groups the all-far skip keeps
    are swept (``far_plain``)."""
    check_k(k)
    check_points_verts(points, verts, min_verts=k)
    if far_skip > 0:
        return far_plain(points, verts, k, far_skip, packed=True,
                         sweep=lambda p, v: knn_packed_plain(p, v, k,
                                                             max_elems))
    B, N, _ = points.shape
    V = verts.shape[1]
    if N == 0:
        return (points.new_empty((B, k, 0)),
                torch.empty((B, k, 0), dtype=torch.int32, device=points.device))
    vx, vy, vz = (verts[..., c][:, None, :] for c in range(3))  # (B, 1, V)
    m2x, m2y, m2z = -(vx + vx), -(vy + vy), -(vz + vz)
    vq = vx * vx + vy * vy + vz * vz
    col = torch.arange(V, dtype=torch.int32, device=points.device)
    chunk = max(1, max_elems // V)
    keys = []
    for s in range(0, N, chunk):
        p = points[:, s:s + chunk]
        px, py, pz = p[..., 0:1], p[..., 1:2], p[..., 2:3]   # (B, c, 1)
        pp = px * px + py * py + pz * pz
        d2 = torch.clamp_min(pp + (m2z * pz + (m2y * py + (m2x * px + vq))),
                             0.0)
        key = (d2.view(torch.int32) & KEY_MASK) | col
        keys.append(torch.topk(key, k, dim=-1, largest=False,
                               sorted=True).values)
    top = torch.cat(keys, dim=1).transpose(1, 2).contiguous()  # (B, k, N)
    d = ieee_sqrt((top & KEY_MASK).view(torch.float32))
    return d, top & 0x1FFF


def exact_rows(verts: torch.Tensor):
    """(B, V, 3) verts -> what the exact kernel sweeps: rows (B, Vp, 4)
    float32 (x, y, z, 0), Vp = V padded to whole 512-vertex tiles with rows
    (+inf, +inf, +inf, 0), and the AABBs [lo xyz, hi xyz, 0, 0] of the real
    vertices of each 64-vertex sub-tile (B, Vp / 64, 8) and each tile
    (B, Vp / 512, 8) (lo +inf, hi -inf where there are none): the rows
    kernel in ``csrc/knn_exact.cu`` on CUDA tensors, ``exact_rows_plain``
    on CPU tensors."""
    check_points_verts(verts, verts, min_verts=1, max_verts=EXACT_MAX_VERTS)
    if verts.device.type == "cpu":
        return exact_rows_plain(verts)
    verts = verts.detach().contiguous()
    _build.check_cuda("exact_rows", verts)
    B, V, _ = verts.shape
    Vp = -(-V // SLOT_TILE) * SLOT_TILE
    rows = torch.empty((B, Vp, 4), dtype=torch.float32, device=verts.device)
    sbox = torch.empty((B, Vp // SUB_TILE, 8), dtype=torch.float32,
                       device=verts.device)
    tbox = torch.empty((B, Vp // SLOT_TILE, 8), dtype=torch.float32,
                       device=verts.device)
    _build.kernel_library().call(
        "animnerf_knn_exact_rows", verts.data_ptr(), rows.data_ptr(),
        sbox.data_ptr(), tbox.data_ptr(), B, V, Vp, _build.stream_of(verts))
    return rows, sbox, tbox


def exact_rows_plain(verts: torch.Tensor):
    """``exact_rows`` in plain torch."""
    B, V, _ = verts.shape
    Vp = -(-V // SLOT_TILE) * SLOT_TILE
    rows = verts.new_zeros((B, Vp, 4))
    rows[:, :, :3] = float("inf")
    rows[:, :V, :3] = verts.detach()
    real = (torch.arange(Vp, device=verts.device) < V)[None, :, None]
    lo = torch.where(real, rows[..., :3], float("inf"))
    hi = torch.where(real, rows[..., :3], float("-inf"))

    def boxes(n):
        return torch.cat([lo.reshape(B, Vp // n, n, 3).amin(dim=2),
                          hi.reshape(B, Vp // n, n, 3).amax(dim=2),
                          verts.new_zeros((B, Vp // n, 2))], dim=-1)

    return rows, boxes(SUB_TILE), boxes(SLOT_TILE)


def knn_exact(points: torch.Tensor, verts: torch.Tensor, k: int = K,
              cull: bool = True, stats: torch.Tensor = None,
              far_skip: float = 0.0, route: str = None):
    """The exact kNN (kernel 9): kernel on CUDA tensors, plain version on
    CPU tensors (which ignores ``cull``: the output is the same either
    way). Any V >= k. ``cull`` lets a warp skip the vertex tiles and
    sub-tiles that cannot change any of its points' slots (exact; pays on
    spatially coherent points). ``stats``: an optional int64 CUDA tensor
    of 2 the kernel adds its [swept, skipped] (point, vertex) pair counts
    to (a warp's point slots, dead ones included, times each tile's or
    sub-tile's vertices; on the "wide" route each pass's real pairs of
    each point; blocks of skipped far groups add nothing).
    ``far_skip`` > 0: the all-far skip at that threshold, the far pass
    first. ``route``: None picks the kernel by k (``EXACT_WIDE_ABOVE``);
    "sweep" or "wide" asks for one (the output is the same)."""
    check_k(k)
    check_points_verts(points, verts, min_verts=k,
                       max_verts=EXACT_MAX_VERTS)
    route = _route(route, k, EXACT_WIDE_ABOVE)
    if points.device.type == "cpu":
        return knn_exact_plain(points, verts, k, far_skip=far_skip)
    points = points.detach().contiguous()
    verts = verts.detach().contiguous()
    _build.check_cuda("knn_exact", points, verts)
    B, N, _ = points.shape
    d, i = _outputs(points, k)
    if N == 0:
        return d, i
    _check_stats(stats, points)
    rows, sbox, tbox = exact_rows(verts)
    flags = _far_pass(points, verts, far_skip, d, i, packed=False,
                      tbox=tbox)
    _build.kernel_library().call(
        "animnerf_knn_exact_wide" if route == "wide" else
        "animnerf_knn_exact", points.data_ptr(), rows.data_ptr(),
        sbox.data_ptr(), tbox.data_ptr(), int(bool(cull)),
        stats.data_ptr() if stats is not None else None,
        flags.data_ptr() if flags is not None else None, d.data_ptr(),
        i.data_ptr(), B, N, verts.shape[1], rows.shape[1], k,
        _build.stream_of(points))
    _build.LAUNCHES["knn_exact"] += 1
    if route == "wide":
        _build.LAUNCHES["knn_exact_wide"] += 1
    if cull:
        _build.LAUNCHES["knn_exact_cull"] += 1
    return d, i


def exact_d2(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """(B, c, 3) x (B, V, 3) -> (B, c, V) squared distances
    ((vx-px)^2 + (vy-py)^2) + (vz-pz)^2, each operation rounded on its own
    (separate elementwise ops: nothing is contracted into an FMA)."""
    d2 = verts[..., 0][:, None, :] - points[..., 0:1]
    d2.mul_(d2)
    for c in (1, 2):
        e = verts[..., c][:, None, :] - points[..., c:c + 1]
        d2.add_(e.mul_(e))
    return d2


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, through float64 (torch's vectorized
    float32 CPU sqrt is not correctly rounded; the kernels' sqrtf is)."""
    return torch.sqrt(x.double()).float()


def _flip_negative(b: torch.Tensor) -> torch.Tensor:
    """int32 float bits <-> int32 whose signed order is the floats' order
    (its own inverse)."""
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 in the floats' order (-0 as +0)."""
    return _flip_negative((x + 0.0).view(torch.int32))


def _sorting_network(k: int):
    """The TPU kernels' final compare-swap pairs (knn_pallas.py:149-155)."""
    if k == 4:
        return ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))
    return tuple((a, a + 1) for end in range(k - 1, 0, -1)
                 for a in range(end))


def tile_slots_topk(d2: torch.Tensor, k: int):
    """The TPU kernels' top-k rule on (B, c, V) squared distances -> (d2,
    idx int32), each (B, c, k), ascending: k slots start at (+inf, 0); per
    512-vertex tile in index order, its k smallest (d2, index) pairs
    (int64 keys, ascending) each replace the first slot holding the slots'
    maximum (``torch.argmax`` returns the first) when strictly smaller;
    then the sorting network, swapping only on a strictly larger d2."""
    B, c, V = d2.shape
    nt = -(-V // SLOT_TILE)
    col = torch.arange(V, dtype=torch.int64, device=d2.device)
    key = (_ordered_bits(d2).to(torch.int64) << 32) | col
    pad = nt * SLOT_TILE - V
    if pad:
        key = torch.cat([key, key.new_full((B, c, pad), _PAD_KEY)], dim=-1)
    top = torch.topk(key.reshape(B, c, nt, SLOT_TILE), k, dim=-1,
                     largest=False, sorted=True).values      # (B, c, nt, k)
    td = _flip_negative((top >> 32).to(torch.int32)).view(torch.float32)
    ti = (top & 0xFFFFFFFF).to(torch.int32)
    sd = d2.new_full((B, c, k), float("inf"))
    si = torch.zeros((B, c, k), dtype=torch.int32, device=d2.device)
    for t in range(nt):
        for s in range(k):
            am = torch.argmax(sd, dim=-1, keepdim=True)
            mx = torch.gather(sd, -1, am)
            cand = td[:, :, t, s:s + 1]
            repl = cand < mx
            sd.scatter_(-1, am, torch.where(repl, cand, mx))
            si.scatter_(-1, am, torch.where(repl, ti[:, :, t, s:s + 1],
                                            torch.gather(si, -1, am)))
    ds, is_ = list(sd.unbind(-1)), list(si.unbind(-1))
    for a, b in _sorting_network(k):
        swap = ds[a] > ds[b]
        ds[a], ds[b] = (torch.where(swap, ds[b], ds[a]),
                        torch.where(swap, ds[a], ds[b]))
        is_[a], is_[b] = (torch.where(swap, is_[b], is_[a]),
                          torch.where(swap, is_[a], is_[b]))
    return torch.stack(ds, -1), torch.stack(is_, -1)


def knn_exact_plain(points: torch.Tensor, verts: torch.Tensor, k: int = K,
                    max_elems: int = 1 << 22, far_skip: float = 0.0):
    """The exact kNN in chunks over N (a (chunk x V) matrix below
    ``max_elems``): d2 as ``exact_d2``, then ``tile_slots_topk``.
    ``far_skip`` > 0: only the points of the groups the all-far skip keeps
    are swept (``far_plain``)."""
    check_k(k)
    check_points_verts(points, verts, min_verts=k, max_verts=2**31 - 1)
    points, verts = points.detach(), verts.detach()
    if far_skip > 0:
        return far_plain(points, verts, k, far_skip, packed=False,
                         sweep=lambda p, v: knn_exact_plain(p, v, k,
                                                            max_elems))
    B, N, _ = points.shape
    V = verts.shape[1]
    if N == 0:
        return (points.new_empty((B, k, 0)),
                torch.empty((B, k, 0), dtype=torch.int32, device=points.device))
    chunk = max(1, max_elems // V)
    parts = [tile_slots_topk(exact_d2(points[:, s:s + chunk], verts), k)
             for s in range(0, N, chunk)]
    d2 = torch.cat([p[0] for p in parts], dim=1).transpose(1, 2)
    idx = torch.cat([p[1] for p in parts], dim=1).transpose(1, 2)
    return ieee_sqrt(d2.contiguous()), idx.contiguous()


def knn(points: torch.Tensor, verts: torch.Tensor, k: int = K,
        tile_skip: bool = False, packed: bool = True,
        far_skip: float = 0.0):
    """The top-k kNN as ``knn_pallas`` picks its kernel: packed keys when
    ``packed`` and V <= 8192 (``knn_top4`` with ``tile_skip`` at k=4,
    ``knn_packed`` otherwise), the exact kernel with its cull otherwise.
    As in the JAX package only the k=4 packed kernel has the tile skip;
    the others ignore it. All three take the all-far skip (``far_skip``).
    ``ANIMNERF_KNN_PACKED=0`` (read at each call) takes the exact kernel
    for every V."""
    packed = packed and os.environ.get("ANIMNERF_KNN_PACKED", "1") == "1"
    if packed and verts.shape[1] <= MAX_VERTS:
        if k == K:
            return knn_top4(points, verts, tile_skip=tile_skip,
                            far_skip=far_skip)
        return knn_packed(points, verts, k, far_skip=far_skip)
    return knn_exact(points, verts, k, cull=True, far_skip=far_skip)


# ------------------------------------------------------------ all-far skip


def far_threshold(far_skip: float) -> float:
    """far2: ``float(far_skip) ** 2`` squared in double and rounded once to
    float32 (``knn_pallas.py:603-615``), which is not float32(thr) squared
    in float32."""
    return torch.tensor(float(far_skip) ** 2, dtype=torch.float32).item()


def far_bound_plain(points: torch.Tensor, tbox: torch.Tensor,
                    max_elems: int = 1 << 24) -> torch.Tensor:
    """(B, N, 3) points and (B, T, 8) tile boxes [lo xyz, hi xyz, ..] ->
    g_lb2 (B, N): per point the minimum over the tiles of ((0 + gx*gx) +
    gy*gy) + gz*gz, gap = max(max(lo - p, p - hi), 0) per axis, each
    operation its own (separately rounded) elementwise op."""
    B, N, _ = points.shape
    T = tbox.shape[1]
    lo = [tbox[:, None, :, a] for a in range(3)]              # (B, 1, T)
    hi = [tbox[:, None, :, 3 + a] for a in range(3)]
    chunk = max(1, max_elems // max(T, 1))
    out = []
    for s in range(0, N, chunk):
        p = points[:, s:s + chunk]
        lb2 = None
        for a in range(3):
            pa = p[..., a:a + 1]                              # (B, c, 1)
            gap = torch.clamp_min(torch.maximum(lo[a] - pa, pa - hi[a]), 0.0)
            sq = gap * gap
            lb2 = sq if lb2 is None else lb2 + sq
        out.append(lb2.amin(dim=-1))
    return torch.cat(out, dim=1) if out else points.new_empty((B, 0))


def far_groups_plain(points: torch.Tensor, verts: torch.Tensor,
                     far_skip: float):
    """The far pass in plain torch: (g_lb2 (B, N), skip (B, G) bool) for
    G = ceil(N / FAR_GROUP) groups; the last group is padded with points
    at the origin, whose bound takes part in its minimum, as
    ``knn_pallas`` pads N with zeros."""
    B, N, _ = points.shape
    tbox = exact_rows_plain(verts)[2]
    g = far_bound_plain(points.detach(), tbox)
    G = -(-N // FAR_GROUP)
    pad = G * FAR_GROUP - N
    full = g
    if pad:
        g0 = far_bound_plain(points.new_zeros((B, 1, 3)), tbox)
        full = torch.cat([g, g0.expand(B, pad)], dim=1)
    gmin = full.reshape(B, G, FAR_GROUP).amin(dim=-1)
    return g, gmin > far_threshold(far_skip)


def far_outputs(g_lb2: torch.Tensor, k: int, packed: bool):
    """A skipped point's outputs from its bound g_lb2 (B, N): distances
    (B, k, N), sqrt(g_lb2) (exact) or the square root of the key rounded
    up one quantum (packed), and index 0."""
    if packed:
        bits = ((g_lb2.contiguous().view(torch.int32) & KEY_MASK)
                + 0x2000) & KEY_MASK
        g_lb2 = bits.view(torch.float32)
    d = ieee_sqrt(g_lb2)[:, None].expand(-1, k, -1).contiguous()
    return d, torch.zeros(d.shape, dtype=torch.int32, device=d.device)


def far_plain(points, verts, k: int, far_skip: float, packed: bool, sweep):
    """The all-far skip around a plain sweep: the skipped groups' points
    get ``far_outputs``, ``sweep`` ((1, n, 3) points, (1, V, 3) verts ->
    (d, i)) runs on the points of each batch element's kept groups."""
    B, N, _ = points.shape
    g, skip = far_groups_plain(points, verts, far_skip)
    d, i = far_outputs(g, k, packed)
    keep = ~skip.repeat_interleave(FAR_GROUP, dim=1)[:, :N]
    for b in range(B):
        n = torch.nonzero(keep[b])[:, 0]
        if len(n):
            ds, is_ = sweep(points[b:b + 1, n], verts[b:b + 1])
            d[b, :, n], i[b, :, n] = ds[0], is_[0]
    return d, i


# per CUDA device: int64 [groups, skipped] that every far pass adds to
_FAR_COUNTS: dict = {}


def far_counts(device) -> torch.Tensor:
    """The far passes' [groups, skipped] counts on ``device`` since the
    last ``reset_far_counts`` (an int64 tensor of 2 on the device; reading
    it synchronises)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _FAR_COUNTS:
        _FAR_COUNTS[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _FAR_COUNTS[device]


def reset_far_counts() -> None:
    for c in _FAR_COUNTS.values():
        c.zero_()


def _far_pass(points, verts, far_skip: float, d, i, packed: bool,
              tbox=None):
    """Launch the far pass (``csrc/knn_far.cu``) when far_skip > 0: it
    writes the skipped groups' outputs into d, i, adds to ``far_counts``
    and returns the flags (B, G) int32 the sweep reads; None when far_skip
    == 0. tbox: the 512-vertex tile boxes of ``exact_rows`` (computed when
    not given)."""
    if not far_skip > 0:
        return None
    B, N, _ = points.shape
    if tbox is None:
        tbox = exact_rows(verts)[2]
    flags = torch.empty((B, -(-N // FAR_GROUP)), dtype=torch.int32,
                        device=points.device)
    _build.kernel_library().call(
        "animnerf_knn_far", points.data_ptr(), tbox.data_ptr(),
        flags.data_ptr(), far_counts(points.device).data_ptr(),
        d.data_ptr(), i.data_ptr(), B, N, tbox.shape[1],
        far_threshold(far_skip), d.shape[1], int(packed),
        _build.stream_of(points))
    _build.LAUNCHES["knn_far"] += 1
    return flags
