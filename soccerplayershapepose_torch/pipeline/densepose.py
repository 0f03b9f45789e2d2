"""DensePose IUV results: the PNG codec, decode, paste and silhouette.

Counterpart of ``soccerplayershapepose_tpu/pipeline/densepose.py``, copied
so the port never imports the JAX package: a self-contained 8-bit PNG
reader (zlib inflate and scanline unfiltering, non-interlaced gray,
gray-alpha, RGB and RGBA) and a writer (filter 0); ``io.formats.write_png``
writes through :func:`encode_png`, so both packages write the same bytes
for the same image. A DensePose predictor emits one PNG-compressed
(H, W, 3) IUV byte image per detection box (raw or base64):
:func:`decode_iuv_result` decodes it, :func:`paste_iuv_into_frame` pastes
it into a full-frame canvas at its box, and :func:`iuv_to_silhouette`
takes the person mask from the I (part) channel. Host numpy only.
"""

from __future__ import annotations

import base64
import struct
import zlib
from typing import Optional, Tuple

import numpy as np


def decode_png(data: bytes) -> np.ndarray:
    """Minimal PNG decoder: 8-bit gray/RGB/RGBA, non-interlaced.

    Returns (H, W) or (H, W, C) uint8.
    """
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    width = height = None
    color_type = None
    idat = b""
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if bit_depth != 8:
                raise ValueError(f"unsupported bit depth {bit_depth}")
            if interlace != 0:
                raise ValueError("interlaced PNG unsupported")
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break

    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = width * channels
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if filt == 0:
            rec = line
        elif filt == 1:       # Sub
            rec = line
            for x in range(channels, stride):
                rec[x] = (int(rec[x]) + int(rec[x - channels])) & 0xFF
        elif filt == 2:       # Up
            rec = (line.astype(np.int32) + prev).astype(np.uint8)
        elif filt == 3:       # Average
            rec = line
            for x in range(stride):
                left = rec[x - channels] if x >= channels else 0
                rec[x] = (int(rec[x]) + ((int(left) + int(prev[x])) >> 1)) & 0xFF
        elif filt == 4:       # Paeth
            rec = line
            for x in range(stride):
                a = int(rec[x - channels]) if x >= channels else 0
                b = int(prev[x])
                c = int(prev[x - channels]) if x >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[x] = (int(rec[x]) + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {filt}")
        out[y] = rec
        prev = out[y]
    img = out.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def encode_png(img: np.ndarray) -> bytes:
    """Inverse of :func:`decode_png` (filter 0 only)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def decode_iuv_result(shape: Optional[Tuple[int, int, int]],
                      data) -> np.ndarray:
    """DensePose result payload (PNG bytes, or their base64 string) →
    (H, W, 3) uint8 IUV; a gray payload is repeated over the 3 channels.
    ``shape`` (C, H, W), when given, must match the decoded H, W."""
    if isinstance(data, str):
        data = base64.b64decode(data)
    img = decode_png(bytes(data))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if shape is not None and img.shape[:2] != tuple(shape[1:3]):
        raise ValueError("IUV payload is %s, not %s" % (img.shape, shape))
    return img


def paste_iuv_into_frame(frame_hw: Tuple[int, int], iuv_patch: np.ndarray,
                         box: np.ndarray) -> np.ndarray:
    """A zero (H, W, 3) uint8 canvas with ``iuv_patch`` pasted at the box's
    rounded top-left corner, clipped at the frame's right and bottom."""
    canvas = np.zeros(frame_hw + (3,), np.uint8)
    x1, y1 = int(round(float(box[0]))), int(round(float(box[1])))
    h, w = iuv_patch.shape[:2]
    x2, y2 = min(x1 + w, frame_hw[1]), min(y1 + h, frame_hw[0])
    canvas[y1:y2, x1:x2] = iuv_patch[:y2 - y1, :x2 - x1]
    return canvas


def iuv_to_silhouette(iuv: np.ndarray) -> np.ndarray:
    """Binary uint8 silhouette: 1 where the I (part) channel is non-zero."""
    return (iuv[..., 0] != 0).astype(np.uint8)
