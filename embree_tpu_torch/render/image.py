"""Image I/O (PPM/PFM/PNG) — analog of tutorials/common/image.

Copy (numpy only) of embree_tpu/render/image.py: the same bytes in, the
same bytes out.

PPM/PFM are implemented natively (no deps); PNG via matplotlib if present.
Framebuffer convention matches the reference: u8 conversion is
int(255 * clamp(c, 0, 1)) per channel (triangle_geometry_device.cpp:193-196).
"""
from __future__ import annotations

import numpy as np


def to_u8(img_f32: np.ndarray) -> np.ndarray:
    return (255.0 * np.clip(np.asarray(img_f32), 0.0, 1.0)).astype(np.uint8)


def write_ppm(path: str, img) -> None:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img[..., :3].tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: P6 <w> <h> <max>\n then binary
    parts = data.split(maxsplit=4)
    assert parts[0] == b"P6"
    w, h, maxv = int(parts[1]), int(parts[2]), int(parts[3])
    raw = parts[4]
    img = np.frombuffer(raw[: w * h * 3], np.uint8).reshape(h, w, 3)
    return img


def write_pfm(path: str, img_f32: np.ndarray) -> None:
    img = np.asarray(img_f32, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode())
        f.write(img[::-1, :, :3].astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(w * h * 3 * 4),
                             "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3)[::-1]


# ---------------------------------------------------------------------------
# PNG (pure python + zlib) — common/image/png.cpp analog
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, img) -> None:
    """8-bit RGB PNG, filter 0 (no per-row filtering), zlib-compressed."""
    import struct
    import zlib

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    img = img[..., :3]
    h, w = img.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """8/16-bit gray/RGB/RGBA PNG (all 5 scanline filters, no
    interlace) -> (h, w, 3) f32 in [0, 1]."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _PNG_SIG, "not a PNG"
    pos = 8
    idat = []
    w = h = depth = ctype = None
    trns = None
    plte = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", payload)
            assert interlace == 0, "interlaced PNG unsupported"
        elif tag == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp_bits = nch * depth
    stride = (w * bpp_bits + 7) // 8
    fbpp = max(1, bpp_bits // 8)   # filter byte distance
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    posr = 0
    for y in range(h):
        ft = raw[posr]
        row = np.frombuffer(raw[posr + 1:posr + 1 + stride],
                            np.uint8).astype(np.int32)
        posr += 1 + stride
        if ft == 0:
            cur = row
        elif ft == 2:     # up
            cur = (row + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - fbpp] if x >= fbpp else 0
                b = prev[x]
                c = prev[x - fbpp] if x >= fbpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                else:         # paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                cur[x] = (row[x] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    if depth == 8:
        px = out[:, :w * nch].reshape(h, w, nch).astype(np.float32) / 255.0
    elif depth == 16:
        u16 = out.reshape(h, -1)[:, :w * nch * 2].reshape(h, w * nch, 2)
        v = (u16[..., 0].astype(np.uint16) << 8) | u16[..., 1]
        px = v.reshape(h, w, nch).astype(np.float32) / 65535.0
    else:
        # 1/2/4-bit gray or palette: unpack bits
        bits = np.unpackbits(out, axis=1)[:, :w * depth].reshape(
            h, w, depth)
        v = np.zeros((h, w), np.int64)
        for b in range(depth):
            v = (v << 1) | bits[:, :, b]
        if ctype == 3:
            px = plte[v].astype(np.float32) / 255.0
            return px
        px = (v.astype(np.float32) / ((1 << depth) - 1))[..., None]
    if ctype == 3:
        px = plte[(px[..., 0] * 255).astype(np.int64)].astype(
            np.float32) / 255.0
        return px
    if px.shape[-1] == 1:
        px = np.repeat(px, 3, axis=-1)
    elif px.shape[-1] == 2:
        px = np.repeat(px[..., :1], 3, axis=-1)
    return px[..., :3]


# ---------------------------------------------------------------------------
# TGA — common/image/tga.cpp analog (type 2 uncompressed + type 10 RLE)
# ---------------------------------------------------------------------------


def write_tga(path: str, img) -> None:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    h, w = img.shape[:2]
    hdr = bytearray(18)
    hdr[2] = 2                      # uncompressed truecolor
    hdr[12] = w & 0xFF
    hdr[13] = (w >> 8) & 0xFF
    hdr[14] = h & 0xFF
    hdr[15] = (h >> 8) & 0xFF
    hdr[16] = 24
    hdr[17] = 0x20                  # top-left origin
    bgr = img[..., :3][..., ::-1]
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.ascontiguousarray(bgr).tobytes())


def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    idlen = data[0]
    imgtype = data[2]
    w = data[12] | (data[13] << 8)
    h = data[14] | (data[15] << 8)
    bpp = data[16]
    desc = data[17]
    nch = bpp // 8
    pos = 18 + idlen
    assert imgtype in (2, 10), f"unsupported TGA type {imgtype}"
    if imgtype == 2:
        px = np.frombuffer(data[pos:pos + w * h * nch],
                           np.uint8).reshape(h, w, nch)
    else:                            # RLE
        out = np.empty((h * w, nch), np.uint8)
        n = 0
        while n < h * w:
            pkt = data[pos]
            pos += 1
            cnt = (pkt & 0x7F) + 1
            if pkt & 0x80:           # run
                out[n:n + cnt] = np.frombuffer(
                    data[pos:pos + nch], np.uint8)
                pos += nch
            else:                    # literal
                out[n:n + cnt] = np.frombuffer(
                    data[pos:pos + cnt * nch],
                    np.uint8).reshape(cnt, nch)
                pos += cnt * nch
            n += cnt
        px = out.reshape(h, w, nch)
    if not (desc & 0x20):            # bottom-left origin -> flip
        px = px[::-1]
    rgb = px[..., :3][..., ::-1].astype(np.float32) / 255.0
    if nch == 1:
        rgb = np.repeat(px.astype(np.float32) / 255.0, 3, axis=-1)
    return rgb


def load_image(path: str):
    """Extension-dispatched reader -> (h, w, 3) f32 in [0, 1] or None
    (common/image/image.cpp loadImageFromDisk analog)."""
    import os as _os
    ext = _os.path.splitext(path)[1].lower()
    try:
        if ext == ".ppm":
            return read_ppm(path).astype(np.float32) / 255.0
        if ext == ".pfm":
            return read_pfm(path)
        if ext == ".png":
            return read_png(path)
        if ext == ".tga":
            return read_tga(path)
        import matplotlib.image as mpimg   # jpg etc.
        img = mpimg.imread(path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return img[..., :3]
    except Exception:
        return None
