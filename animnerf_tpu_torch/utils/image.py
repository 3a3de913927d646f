"""The image operations of the host data pipeline, in numpy.

The JAX package calls OpenCV for these (PNG decode and encode, resize,
undistort, erode / dilate, the JET colour map, the synthetic splats) and
PIL for the PNG of TensorBoard images. The port reproduces what OpenCV
computes, so that one dataset gives the same batches through either
package (``tests/test_torch_image_ops.py`` holds each function against
``cv2`` bit for bit):

  * ``read_png`` / ``write_png`` / ``encode_png``: 8-bit gray, RGB and
    RGBA on ``zlib``, all five row filters on reading (OpenCV can write
    any of them, or choose per row); ``read_rgb``: a frame as
    ``cv2.imread`` reads it in colour;
  * ``resize_linear_u8``: OpenCV's uint8 ``INTER_LINEAR``, fixed point with
    11-bit coefficients, and its exact 2x downscale (a 2x2 box average);
  * ``undistort_u8``: ``initUndistortRectifyMap`` on a 1/32-pixel table
    and the bilinear ``remap`` with 15-bit weights and a zero border;
  * ``erode`` / ``dilate``: a rectangle with OpenCV's anchor ``k // 2``;
    pixels outside the image never take part;
  * ``colormap_jet``: OpenCV's 256-entry JET table;
  * ``rasterize_disc``: the filled radius-2 disc of ``cv2.circle``.

Images are (H, W) or (H, W, C) arrays in RGB(A) channel order.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# ------------------------------------------------------------------- PNG

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit gray, RGB, gray + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            row = line.copy()
        elif ftype == 1:  # Sub: a running sum along each channel
            row = np.cumsum(line.reshape(-1, bpp).astype(np.uint32),
                            axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            row = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                cur, prev.tobytes(), bpp)
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} is not defined")
        out[y] = row
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced gray, RGB, gray-alpha or RGBA PNG ->
    uint8 (H, W) or (H, W, C), channels in the file's order (RGB(A))."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path!r} is not a PNG file")
    pos, idat, header = len(_PNG_SIG), [], None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path!r}: only 8-bit non-interlaced gray / RGB / RGBA PNGs "
            f"are read (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace})")
    cn = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * cn, cn)
    img = rows.reshape(height, width, cn)
    return img[..., 0] if cn == 1 else img


def read_rgb(path: str) -> np.ndarray:
    """A frame as (H, W, 3) uint8 RGB, as ``cv2.imread`` reads a PNG in
    colour (an alpha channel dropped, gray repeated), in RGB order. The
    port decodes PNG only: a JPEG frame raises ``ValueError`` naming it."""
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        raise ValueError(
            f"{path!r} is a JPEG frame, and the port decodes PNG only (it "
            "has no JPEG decoder without OpenCV or PIL): extract the "
            "frames as PNG (python -m animnerf_tpu_torch.tools."
            "video_to_images) or pass a reader that decodes them")
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] < 3:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W), (H, W, 3) or (H, W, 4) -> the bytes of an 8-bit PNG
    (gray, RGB or RGBA), every row with the Up filter."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    height, width, cn = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(cn)
    if ctype is None:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, got {cn}")
    rows = img.reshape(height, width * cn)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((height, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write ``encode_png(img)`` to path."""
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------- resize

_RESIZE_BITS = 11  # INTER_RESIZE_COEF_BITS


def _linear_taps(src: int, dst: int, clamp: bool):
    """Source indices and 11-bit weights of OpenCV's linear resize along
    one axis. Along x a tap that falls off the image is moved onto it with
    weight 1; along y the fraction is kept and the row index is clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        out = (s < 0) | (s >= src - 1)
        f[out] = 0
        s = np.clip(s, 0, src - 1)
    one = np.float32(1 << _RESIZE_BITS)
    w1 = np.rint(f * one).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, size: tuple) -> np.ndarray:
    """``cv2.resize(img, size)`` (INTER_LINEAR) of a uint8 image;
    size = (W, H). Rows are blended horizontally in int32 with 11-bit
    weights, then vertically as OpenCV's SIMD path does it:
    (((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16), rounded by 2 bits.
    An exact 2x downscale is OpenCV's 2x2 box average."""
    W, H = size
    h, w = img.shape[:2]
    im = np.asarray(img, np.uint8)
    if (w, h) == (W, H):
        return im.copy()
    if w == 2 * W and h == 2 * H:
        x = im.astype(np.int32)
        box = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
               + x[1::2, 1::2] + 2) >> 2
        return box.astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(w, W, clamp=True)
    y0, y1, b0, b1 = _linear_taps(h, H, clamp=False)
    x = im.astype(np.int64).reshape(h, w, -1)
    rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    v = ((((rows[y0] >> 4) * b0) >> 16)
         + (((rows[y1] >> 4) * b1) >> 16) + 2) >> 2
    out = np.clip(v, 0, 255).astype(np.uint8)
    return out.reshape((H, W) + im.shape[2:])


# ------------------------------------------------------------- undistort

_TAB_BITS = 5      # INTER_BITS: 1/32-pixel map
_REMAP_BITS = 15   # INTER_REMAP_COEF_BITS


def tilt_matrix(tau_x: float, tau_y: float) -> np.ndarray:
    """OpenCV's ``computeTiltProjectionMatrix``: the projection of the
    sensor tilted by tau_x about x and tau_y about y (3 x 3, float64)."""
    cx, sx = np.cos(tau_x), np.sin(tau_x)
    cy, sy = np.cos(tau_y), np.sin(tau_y)
    rot_x = np.array([[1, 0, 0], [0, cx, sx], [0, -sx, cx]])
    rot_y = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    rot_xy = rot_y @ rot_x
    proj_z = np.array([[rot_xy[2, 2], 0, -rot_xy[0, 2]],
                       [0, rot_xy[2, 2], -rot_xy[1, 2]], [0, 0, 1]])
    return proj_z @ rot_xy


def undistort_maps(K: np.ndarray, D, H: int, W: int):
    """``initUndistortRectifyMap(K, D, I, K, (W, H))`` in float64: the
    distorted source position (u, v) of every output pixel under OpenCV's
    full model, D = (k1, k2, p1, p2[, k3[, k4, k5, k6[, s1, s2, s3, s4[,
    tau_x, tau_y]]]]): the rational radial factor (k1..k3 over k4..k6),
    the tangential (p1, p2) and thin-prism (s1..s4) terms, then the tilt
    projection; coefficients past those given are 0."""
    K = np.asarray(K, np.float64)
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    coeffs = np.ravel(np.asarray(D, np.float64))
    if coeffs.size > 14:
        raise ValueError(f"OpenCV's model has at most 14 distortion "
                         f"coefficients, got {coeffs.size}")
    d = np.zeros(14)
    d[:coeffs.size] = coeffs
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tau_x, tau_y = d
    T = tilt_matrix(tau_x, tau_y)
    ir = np.linalg.inv(K).ravel()
    i = np.arange(H, dtype=np.float64)[:, None]
    j = np.arange(W, dtype=np.float64)[None, :]
    w = 1.0 / (i * ir[7] + ir[8] + j * ir[6])
    x = (i * ir[1] + ir[2] + j * ir[0]) * w
    y = (i * ir[4] + ir[5] + j * ir[3]) * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    xd = (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2) + s1 * r2
          + s2 * r2 * r2)
    yd = (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2 + s3 * r2
          + s4 * r2 * r2)
    t0 = T[0, 0] * xd + T[0, 1] * yd + T[0, 2]
    t1 = T[1, 0] * xd + T[1, 1] * yd + T[1, 2]
    t2 = T[2, 0] * xd + T[2, 1] * yd + T[2, 2]
    inv = np.where(t2 != 0, 1.0 / np.where(t2 != 0, t2, 1.0), 1.0)
    u = fx * inv * t0 + u0
    v = fy * inv * t1 + v0
    return u, v


def remap_linear_u8(img: np.ndarray, u: np.ndarray,
                    v: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, u, v, INTER_LINEAR, BORDER_CONSTANT)`` through the
    fixed-point map OpenCV builds: positions rounded to 1/32 pixel, the
    2x2 taps weighted by 15-bit products, pixels outside read as 0."""
    im = np.asarray(img, np.uint8)
    h, w = im.shape[:2]
    x = im.astype(np.int64).reshape(h, w, -1)
    iu = np.rint(u * (1 << _TAB_BITS)).astype(np.int64)
    iv = np.rint(v * (1 << _TAB_BITS)).astype(np.int64)
    sx, sy = iu >> _TAB_BITS, iv >> _TAB_BITS
    tx, ty = iu & 31, iv & 31
    pad = np.zeros((h + 2, w + 2, x.shape[2]), np.int64)
    pad[1:-1, 1:-1] = x

    def tap(r, c):
        inside = (r >= -1) & (r <= h) & (c >= -1) & (c <= w)
        val = pad[np.clip(r + 1, 0, h + 1), np.clip(c + 1, 0, w + 1)]
        return val * inside[..., None]

    # (32 - t) * (32 - s) * 32 is the 15-bit product of the two 1/32 steps
    acc = (tap(sy, sx) * ((32 - ty) * (32 - tx) * 32)[..., None]
           + tap(sy, sx + 1) * ((32 - ty) * tx * 32)[..., None]
           + tap(sy + 1, sx) * (ty * (32 - tx) * 32)[..., None]
           + tap(sy + 1, sx + 1) * (ty * tx * 32)[..., None])
    out = np.clip((acc + (1 << (_REMAP_BITS - 1))) >> _REMAP_BITS, 0, 255)
    return out.astype(np.uint8).reshape(im.shape)


def undistort_u8(img: np.ndarray, K: np.ndarray, D) -> np.ndarray:
    """``cv2.undistort(img, K, D)`` of a uint8 image (the new camera is
    K). Zero coefficients return the image unchanged, as OpenCV's map
    then rounds to the identity."""
    if not np.any(np.asarray(D, np.float64)):
        return np.array(img, np.uint8, copy=True)
    h, w = img.shape[:2]
    return remap_linear_u8(img, *undistort_maps(K, D, h, w))


# ------------------------------------------------------------ morphology


def _rect_filter(img: np.ndarray, k: int, fn, fill: float) -> np.ndarray:
    """fn (np.minimum / np.maximum) over the k x k rectangle anchored at
    (k // 2, k // 2): rows y - k//2 .. y - k//2 + k - 1; ``fill`` outside
    makes pixels beyond the border take no part."""
    x = np.asarray(img)
    h, w = x.shape
    a = k // 2
    pad = np.full((h + k - 1, w + k - 1), fill, x.dtype)
    pad[a:a + h, a:a + w] = x
    rows = pad[0:h]
    for i in range(1, k):
        rows = fn(rows, pad[i:i + h])
    out = rows[:, 0:w]
    for j in range(1, k):
        out = fn(out, rows[:, j:j + w])
    return out


def _extreme(dtype, top: bool):
    if np.issubdtype(dtype, np.floating):
        return np.inf if top else -np.inf
    info = np.iinfo(dtype)
    return info.max if top else info.min


def erode(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.erode(img, np.ones((k, k)))`` of a single-channel image."""
    x = np.asarray(img)
    return _rect_filter(x, k, np.minimum, _extreme(x.dtype, True))


def dilate(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(img, np.ones((k, k)))`` of a single-channel image."""
    x = np.asarray(img)
    return _rect_filter(x, k, np.maximum, _extreme(x.dtype, False))


# -------------------------------------------------------------- drawing


def colormap_jet() -> np.ndarray:
    """OpenCV's COLORMAP_JET as a (256, 3) uint8 RGB table: piecewise
    linear with slope 4 between its knots."""
    i = np.arange(256, dtype=np.float64)
    r = np.interp(i, [0, 95, 96, 159, 160, 223, 224, 255],
                  [0, 0, 2, 254, 255, 255, 252, 128])
    g = np.interp(i, [0, 32, 95, 96, 159, 160, 223, 255],
                  [0, 0, 252, 255, 255, 252, 0, 0])
    b = np.interp(i, [0, 31, 32, 95, 96, 158, 159, 160, 255],
                  [128, 252, 255, 255, 254, 6, 1, 0, 0])
    return np.stack([r, g, b], axis=1).astype(np.uint8)


def apply_jet(x: np.ndarray) -> np.ndarray:
    """uint8 (H, W) -> (H, W, 3) RGB, as ``cv2.applyColorMap(x,
    COLORMAP_JET)`` converted to RGB."""
    return colormap_jet()[np.asarray(x, np.uint8)]


# the pixels of cv2.circle(img, centre, 2, colour, -1): |dy| + |dx| <= 2
_DISC2 = np.array([(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
                   if abs(dy) + abs(dx) <= 2], np.int64)


def rasterize_disc(img: np.ndarray, u, v, colour) -> None:
    """Fill radius-2 discs in place, as ``cv2.circle(img, (u, v), 2,
    colour, -1)`` called for each centre in turn: u the columns, v the
    rows (ints or (N,) arrays), colour one value per channel or (N, C);
    clipped to the image, a later disc painting over an earlier one."""
    h, w = img.shape[:2]
    u = np.atleast_1d(np.asarray(u, np.int64))
    v = np.atleast_1d(np.asarray(v, np.int64))
    colour = np.broadcast_to(np.asarray(colour),
                             (len(u),) + img.shape[2:])
    r = (v[:, None] + _DISC2[None, :, 0]).reshape(-1)
    c = (u[:, None] + _DISC2[None, :, 1]).reshape(-1)
    who = np.repeat(np.arange(len(u)), len(_DISC2))
    keep = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    pix, who = (r * w + c)[keep], who[keep]
    # each pixel takes the last disc painted over it
    last = len(pix) - 1 - np.unique(pix[::-1], return_index=True)[1]
    flat = img.reshape((h * w,) + img.shape[2:])
    flat[pix[last]] = colour[who[last]]


# ------------------------------------------------------------------- GIF

# pixels between clear codes: the decoder's table grows by one entry a
# code, and after 254 literals it holds entries up to 510, so every code
# stays 9 bits wide (the width grows at entry 512)
_GIF_RUN = 254
_GIF_CLEAR, _GIF_END = 256, 257


def gif_palette(img: np.ndarray, colors: int = 256):
    """uint8 (H, W, 3) -> (palette (colors, 3) uint8, indices (H, W)
    uint8): median cut over the frame's colours binned at 6 bits a
    channel (each bin at the mean of its pixels); a pixel takes the entry
    of its bin's box, the mean colour of the box's pixels. A frame of at
    most ``colors`` colours gets them exactly."""
    img = np.asarray(img, np.uint8)
    q = (img >> 2).astype(np.int32)
    key = ((q[..., 0] << 12) | (q[..., 1] << 6) | q[..., 2]).reshape(-1)
    counts = np.bincount(key, minlength=1 << 18)
    bins = np.flatnonzero(counts)
    flat = img.reshape(-1, 3)
    if len(bins) <= colors:
        # few colours (masks, rasters): each its own entry, exact
        rgb = (flat[:, 0].astype(np.int32) << 16
               | flat[:, 1].astype(np.int32) << 8 | flat[:, 2])
        uniq, idx = np.unique(rgb, return_inverse=True)
        if len(uniq) <= colors:
            palette = np.zeros((colors, 3), np.uint8)
            palette[:len(uniq)] = np.stack(
                [uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
            return palette, idx.astype(np.uint8).reshape(img.shape[:2])
    means = np.stack([np.bincount(key, flat[:, c], 1 << 18)[bins]
                      for c in range(3)], axis=1) / counts[bins, None]
    counts = counts[bins]

    def scored(box):
        # split priority: pixels x widest channel range
        rng = np.ptp(means[box], axis=0)
        return (float(counts[box].sum() * rng.max()), int(np.argmax(rng)),
                box)

    # median cut: split the box of highest priority at its pixel-weighted
    # median along its widest channel
    boxes = [scored(np.arange(len(bins)))]
    while len(boxes) < colors:
        i = max(range(len(boxes)), key=lambda j: boxes[j][0])
        score, axis, box = boxes[i]
        if score <= 0:
            break
        box = box[np.argsort(means[box, axis], kind="stable")]
        cum = np.cumsum(counts[box])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0) + 1, 1,
                          len(box) - 1))
        boxes[i] = scored(box[:cut])
        boxes.append(scored(box[cut:]))
    palette = np.zeros((colors, 3), np.uint8)
    box_of = np.zeros(1 << 18, np.uint8)
    for i, (_, _, b) in enumerate(boxes):
        mean = (means[b] * counts[b, None]).sum(0) / counts[b].sum()
        palette[i] = np.clip(np.rint(mean), 0, 255).astype(np.uint8)
        box_of[bins[b]] = i
    return palette, box_of[key].reshape(img.shape[:2])


def _gif_lzw(indices: np.ndarray) -> bytes:
    """8-bit palette indices -> GIF image data with no dictionary: a clear
    code, then up to _GIF_RUN literal codes, repeated, then the end code;
    9-bit codes packed LSB first, in sub-blocks of up to 255 bytes."""
    px = np.asarray(indices, np.int32).reshape(-1)
    n_runs = -(-len(px) // _GIF_RUN)
    body = np.full(n_runs * _GIF_RUN, -1, np.int32)  # -1: padding
    body[:len(px)] = px
    codes = np.concatenate([np.full((n_runs, 1), _GIF_CLEAR, np.int32),
                            body.reshape(n_runs, _GIF_RUN)], 1).reshape(-1)
    codes = np.append(codes[codes >= 0], _GIF_END)
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
              for i in range(0, len(data), 255)]
    return bytes([8]) + b"".join(blocks) + b"\x00"


def encode_gif(frames, fps: float = 30.0) -> bytes:
    """uint8 (H, W, 3) frames of one size -> the bytes of a looping GIF89a
    animation, each frame with its own 256-colour palette (``gif_palette``)
    and a delay of round(100 / fps) hundredths of a second."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("encode_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    delay = int(round(100.0 / fps))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0)
           + b"\x00"]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"encode_gif takes uint8 ({h}, {w}, 3) "
                             f"frames, got {f.dtype} {f.shape}")
        palette, idx = gif_palette(f)
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),
                palette.tobytes(), _gif_lzw(idx)]
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames, fps: float = 30.0) -> None:
    """Write ``encode_gif(frames, fps)`` to path (in place of
    ``imageio.mimsave(path, frames, fps=fps)``)."""
    data = encode_gif(frames, fps)
    with open(path, "wb") as f:
        f.write(data)
