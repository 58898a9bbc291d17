"""Host-side image finishing and IO.

Quantization matches the reference exactly: gamma 2.0 via sqrt after
averaging (renderer.rs:30-31), then ``(v * 255.999) as u8`` with Rust's
*saturating* float->int cast semantics — overshoot clamps to 255,
negatives to 0, NaN to 0 (vec3.rs:278-291).

PNG frames are written like main.rs:67-91 (8-bit RGB), encoded with
zlib and numpy alone; GIF assembly (Pillow, optional) is provided for
animations (the reference declares the ``gif`` crate but
never uses it — SphereField.gif was assembled externally).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np


def gamma_encode(linear: np.ndarray) -> np.ndarray:
    """sqrt gamma (renderer.rs:31); clamps negatives to 0 first."""
    return np.sqrt(np.maximum(np.nan_to_num(linear, nan=0.0), 0.0))


def quantize_u8(value: np.ndarray) -> np.ndarray:
    """(v * 255.999) with saturating cast (vec3.rs:279-287)."""
    v = np.nan_to_num(np.asarray(value, np.float64), nan=0.0) * 255.999
    return np.clip(v, 0.0, 255.0).astype(np.uint8)


def to_rgb8(linear_mean: np.ndarray) -> np.ndarray:
    """Linear mean radiance (H, W, 3) -> gamma-2 RGB8."""
    return quantize_u8(gamma_encode(linear_mean))


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, rgb8: np.ndarray) -> None:
    """8-bit RGB PNG (main.rs:78-91), encoded with zlib alone."""
    img = np.ascontiguousarray(np.asarray(rgb8, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png expects (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    # filter type 0 (None) on every scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters (types 0-4) on (H, 1 + stride) bytes."""
    h, n = rows.shape
    out = np.zeros((h, n - 1), np.uint8)
    prev = np.zeros(n - 1, np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(n - 1, np.int32)
            for i in range(n - 1):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                elif ftype == 4:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[i] = (line[i] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """8-bit RGB or RGBA PNG (non-interlaced) -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, ihdr = len(_PNG_SIG), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are supported"
        )
    ch = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw.reshape(h, 1 + w * ch), ch).reshape(h, w, ch)
    return np.ascontiguousarray(px[..., :3])


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float) -> None:
    """Assemble animation frames into a GIF (reference parity for
    preview/SphereField.gif, which was produced outside the code).
    Needs Pillow, which only this optional output uses."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "write_gif needs Pillow (pip install pillow); PNG frames "
            "need nothing beyond numpy"
        ) from e

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    imgs = [Image.fromarray(np.asarray(f, np.uint8), mode="RGB") for f in frames]
    # one adaptive (median-cut) palette shared by every frame, with
    # Floyd-Steinberg dithering — PIL's default per-frame web-safe
    # conversion bands smooth gradients and flickers between frames.
    # Build the palette from a montage sampled ACROSS frames (a
    # fade-in first frame would otherwise pin a near-black palette on
    # the whole animation).
    sample_idx = sorted({0, len(imgs) // 2, len(imgs) - 1})
    sample = [np.asarray(imgs[i]) for i in sample_idx]
    montage = Image.fromarray(np.concatenate(sample, axis=0), mode="RGB")
    base = montage.quantize(colors=256, method=Image.Quantize.MEDIANCUT)
    pal = [
        im.quantize(palette=base, dither=Image.Dither.FLOYDSTEINBERG)
        for im in imgs
    ]
    pal[0].save(
        path,
        save_all=True,
        append_images=pal[1:],
        duration=int(1000.0 / fps),
        loop=0,
    )


def frame_path(output_dir: str, frame_index: int) -> str:
    """./output/image_{:04}.png (main.rs:67)."""
    return os.path.join(output_dir, f"image_{frame_index:04d}.png")
