"""Image output backends.

The reference writes PNG via Go stdlib and EXR/HDR/PFM via OpenImageIO
(internal/output/png.go, oiio.go); the ACES variant stamps ACES-container
metadata (oiio.go:26-41). Here every format is a small numpy + zlib/struct
codec, so the render path needs no imaging library.

Reference output semantics preserved:
- the PNG path applies gamma-2 + clamp(0,1) before quantization
  (leader.go:178-183 → postprocess Gamma+Clamp),
- EXR/HDR/PFM are written linear,
- the ACES EXR carries AP1 chromaticities + adopted-neutral metadata.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from izpi_tpu.io import postprocess


def write(path: str, image: np.ndarray, mode: Optional[str] = None,
          aces: bool = False) -> None:
    """Dispatch by extension or explicit mode ∈ {png, exr, hdr, pfm}."""
    mode = mode or path.rsplit(".", 1)[-1].lower()
    if mode == "png":
        write_png(path, image)
    elif mode == "exr":
        write_exr(path, image, aces=aces)
    elif mode == "hdr":
        write_hdr(path, image)
    elif mode == "pfm":
        write_pfm(path, image)
    else:
        raise ValueError(f"unknown output mode {mode!r}")


def write_png(path: str, image: np.ndarray) -> None:
    """8-bit PNG with the reference's gamma-2 + clamp postfx
    (leader.go:178-183)."""
    img = postprocess.Pipeline([postprocess.Gamma(), postprocess.Clamp()]) \
        .apply(np.asarray(image, np.float64))
    rgb = (img * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = rgb.shape
    # Filter type 0 (None) on every scanline.
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# OpenEXR (scanline, float32, zip-per-scanline) — minimal writer.
# ---------------------------------------------------------------------------


def _exr_attr(name: bytes, type_: bytes, data: bytes) -> bytes:
    return name + b"\0" + type_ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, image: np.ndarray, aces: bool = False) -> None:
    """Write a linear float32 EXR (ZIP-compressed scanlines, channels B,G,R).

    aces=True stamps ACEScg (AP1/D60) chromaticities + adoptedNeutral — the
    analog of the reference's OIIOACES writer metadata (output/oiio.go:26-41).
    """
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape

    channels = b""
    for name in (b"B", b"G", b"R"):
        # pixel type 2 = FLOAT, pLinear 0, sampling 1,1
        channels += name + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    channels += b"\0"

    header = b""
    header += _exr_attr(b"channels", b"chlist", channels)
    # ZIPS (one scanline per chunk) — this writer emits 1-line chunks, and
    # declaring ZIP (16-line chunks) would make standard readers misparse.
    header += _exr_attr(b"compression", b"compression", struct.pack("B", 2))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", struct.pack("B", 0))
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f",
                        struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    if aces:
        # AP1 primaries + D60 white (ACEScg), plus adoptedNeutral.
        chroma = struct.pack("<8f", 0.713, 0.293, 0.165, 0.830,
                             0.128, 0.044, 0.32168, 0.33767)
        header += _exr_attr(b"chromaticities", b"chromaticities", chroma)
        header += _exr_attr(b"adoptedNeutral", b"v2f",
                            struct.pack("<ff", 0.32168, 0.33767))
    header += b"\0"

    # ZIP compression in EXR compresses 1 scanline block at a time with the
    # reorder+delta predictor.
    def exr_zip(raw: bytes) -> bytes:
        data = np.frombuffer(raw, np.uint8)
        half = (len(data) + 1) // 2
        interleaved = np.empty(len(data), np.uint8)
        interleaved[0::2] = data[:half]
        interleaved[1::2] = data[half:half + len(data) - half]
        delta = np.empty(len(data), np.uint8)
        delta[0] = interleaved[0]
        delta[1:] = (interleaved[1:].astype(np.int16)
                     - interleaved[:-1].astype(np.int16) + 128
                     ).astype(np.uint8)
        comp = zlib.compress(delta.tobytes())
        return comp if len(comp) < len(raw) else raw

    blocks = []
    for y in range(h):
        row = img[y]
        raw = (row[:, 2].tobytes() + row[:, 1].tobytes()
               + row[:, 0].tobytes())
        comp = exr_zip(raw)
        blocks.append(struct.pack("<ii", y, len(comp)) + comp)

    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    offset_table_size = 8 * h
    base = len(magic) + len(header) + offset_table_size
    offsets = []
    pos = base
    for blk in blocks:
        offsets.append(pos)
        pos += len(blk)

    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        for off in offsets:
            f.write(struct.pack("<q", off))
        for blk in blocks:
            f.write(blk)


def write_pfm(path: str, image: np.ndarray) -> None:
    """Portable FloatMap (PF, little-endian, bottom-up rows)."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # negative scale = little endian
        f.write(img[::-1].tobytes())


def write_hdr(path: str, image: np.ndarray) -> None:
    """Radiance RGBE (.hdr), uncompressed scanlines."""
    img = np.asarray(image, np.float64)
    h, w, _ = img.shape
    brightest = np.maximum(img.max(axis=-1), 1e-32)
    exponent = np.ceil(np.log2(brightest)).astype(np.int32) + 1
    scale = np.exp2(-exponent + 8)
    rgbe = np.zeros((h, w, 4), np.uint8)
    mantissa = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., :3] = mantissa
    rgbe[..., 3] = (exponent + 128).astype(np.uint8)
    zero = brightest < 1e-30
    rgbe[zero] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# ---------------------------------------------------------------------------
# Readers (texture loading; the analog of the reference's OIIO reads).
# ---------------------------------------------------------------------------


def read_image(path: str) -> np.ndarray:
    """Read PNG/EXR/HDR/PFM to (H,W,3) float32. PNG is returned as raw
    [0,1] values with NO sRGB decode, matching texture/image.go:95-101."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "pfm":
        return _read_pfm(path)
    if ext == "hdr":
        return _read_hdr(path)
    if ext == "exr":
        return _read_exr(path)
    return _read_png(path)


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples


def _png_unfilter(data: np.ndarray, h: int, stride: int, bpp: int):
    """Undo the per-scanline PNG filters (None/Sub/Up/Average/Paeth)."""
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 1:
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype in (3, 4):
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _read_png(path: str) -> np.ndarray:
    """Non-interlaced PNG of 8 or 16 bits per sample, any colour type, as
    raw [0,1] RGB (alpha dropped, gray broadcast)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if interlace or depth not in (8, 16) or ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    n_ch = _PNG_CHANNELS[ctype]
    bpp = n_ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _png_unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        img = px.view(">u2").astype(np.float32) / 65535.0
    else:
        img = px.astype(np.float32) / 255.0
    img = img.reshape(h, w, n_ch)
    if ctype == 3:
        return palette[px.reshape(h, w)].astype(np.float32) / 255.0
    if n_ch <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr): flat or new-style run-length scanlines, the
    standard `-Y h +X w` orientation."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while True:                        # header lines up to the blank one
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8)
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if (8 <= w < 32768 and buf[pos] == 2 and buf[pos + 1] == 2
                and (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) == w):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = int(buf[pos])
                    if n > 128:
                        n -= 128
                        rgbe[y, x:x + n, c] = buf[pos + 1]
                        pos += 2
                    else:
                        rgbe[y, x:x + n, c] = buf[pos + 1:pos + 1 + n]
                        pos += 1 + n
                    x += n
        else:
            rgbe[y] = buf[pos:pos + 4 * w].reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return ((rgbe[..., :3].astype(np.float64) + 0.5)
            * scale[..., None]).astype(np.float32)


def _read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"PF"
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3)[::-1].astype(np.float32)


_EXR_PIXSIZE = {0: 4, 1: 2, 2: 4}   # UINT, HALF, FLOAT
_EXR_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_EXR_COMP_NAMES = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                   5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}


def _exr_unzip(raw: bytes, expect: int) -> bytes:
    """Invert EXR's deflate + delta predictor + two-way interleave."""
    if len(raw) == expect:          # stored uncompressed (zip didn't shrink)
        return raw
    delta = np.frombuffer(zlib.decompress(raw), np.uint8).astype(np.int64)
    rec = np.cumsum(
        np.concatenate([delta[:1], delta[1:] - 128])).astype(np.uint8)
    half = (len(rec) + 1) // 2
    deinter = np.empty(len(rec), np.uint8)
    deinter[:half] = rec[0::2]
    deinter[half:] = rec[1::2]
    return deinter.tobytes()


def _read_exr(path: str) -> np.ndarray:
    """General single-part scanline EXR reader: HALF/FLOAT/UINT pixels, any
    channel names/order, NONE/ZIPS/ZIP compression, increasing or decreasing
    line order. PIZ and the other lossy codecs raise a clear error (the
    reference reads those via OpenImageIO, texture/image.go:31-59; convert
    such assets with `exrheader`/`oiiotool --compression zip` first).
    Returns (H, W, 3) float32 RGB (Y broadcast for grayscale files)."""
    with open(path, "rb") as f:
        data = f.read()
    assert struct.unpack("<i", data[:4])[0] == 20000630, "not an EXR file"
    version = struct.unpack("<i", data[4:8])[0]
    if version & 0x200:
        raise ValueError("tiled EXR is not supported (scanline only)")
    if version & 0x1000:
        raise ValueError("multi-part EXR is not supported")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\0", pos)
        type_ = data[pos:end].decode()
        pos = end + 1
        size = struct.unpack("<i", data[pos:pos + 4])[0]
        pos += 4
        attrs[name] = (type_, data[pos:pos + size])
        pos += size
    pos += 1

    # channel list: (name, pixel_type) in file order (EXR stores them
    # alphabetically; scanline data follows this order)
    chans = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        end = cdata.index(b"\0", cpos)
        cname = cdata[cpos:end].decode()
        cpos = end + 1
        ptype, _, _, _, _, sx, sy = struct.unpack(
            "<iBBBBii", cdata[cpos:cpos + 16])
        cpos += 16
        if sx != 1 or sy != 1:
            raise ValueError(f"subsampled channel {cname!r} not supported")
        if ptype not in _EXR_PIXSIZE:
            raise ValueError(f"unknown pixel type {ptype} for {cname!r}")
        chans.append((cname, ptype))

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3):
        raise ValueError(
            f"EXR compression {_EXR_COMP_NAMES.get(comp, comp)} is not "
            f"supported — re-encode with ZIP/ZIPS/NONE (e.g. "
            f"`oiiotool in.exr --compression zip -o out.exr`)")
    lines_per_block = 16 if comp == 3 else 1
    n_blocks = -(-h // lines_per_block)
    line_order = attrs.get("lineOrder", (None, b"\0"))[1][0]

    if comp == 3 and h > 1:
        # Legacy-writer fallback: an earlier version of this writer declared
        # ZIP (16-line blocks) but emitted one-scanline chunks. Such files
        # have h offsets (first chunk starts right after an h-entry offset
        # table) instead of ceil(h/16); detect and parse them line-wise
        # rather than dying in a short-buffer error.
        legacy_first = struct.unpack("<q", data[pos:pos + 8])[0]
        if legacy_first == pos + 8 * h != pos + 8 * n_blocks:
            lines_per_block = 1
            n_blocks = h

    offsets = struct.unpack(f"<{n_blocks}q", data[pos:pos + 8 * n_blocks])
    bytes_per_line = sum(w * _EXR_PIXSIZE[pt] for _, pt in chans)
    planes = {cname: np.zeros((h, w), np.float32) for cname, _ in chans}
    for off in offsets:
        y, size = struct.unpack("<ii", data[off:off + 8])
        y -= y0
        n_lines = min(lines_per_block, h - y)
        raw = data[off + 8: off + 8 + size]
        if comp in (2, 3):
            raw = _exr_unzip(raw, bytes_per_line * n_lines)
        lpos = 0
        for ly in range(y, y + n_lines):
            for cname, ptype in chans:
                nbytes = w * _EXR_PIXSIZE[ptype]
                vals = np.frombuffer(raw[lpos:lpos + nbytes],
                                     _EXR_DTYPE[ptype])
                planes[cname][ly] = vals.astype(np.float32)
                lpos += nbytes
    if line_order == 1:  # DECREASING_Y: chunks are ordered bottom-up but
        pass             # each chunk's y coordinate is absolute — no flip.

    names = {c for c, _ in chans}
    out = np.zeros((h, w, 3), np.float32)
    if {"R", "G", "B"} <= names:
        for i, c in enumerate("RGB"):
            out[..., i] = planes[c]
    elif "Y" in names:
        out[:] = planes["Y"][..., None]
    else:
        picks = [c for c, _ in chans][:3]
        for i, c in enumerate(picks):
            out[..., i] = planes[c]
        for i in range(len(picks), 3):
            out[..., i] = out[..., max(len(picks) - 1, 0)]
    return out
