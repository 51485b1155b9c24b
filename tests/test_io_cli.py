"""I/O writers, postprocess, scene registry, CLI smoke."""

import os
import subprocess
import sys

import numpy as np

from izpi_tpu.io import output, postprocess


def test_png_roundtrip(tmp_path):
    img = np.random.RandomState(0).rand(8, 12, 3).astype(np.float32)
    p = str(tmp_path / "t.png")
    output.write_png(p, img)
    back = output.read_image(p)
    # PNG path applies gamma-2+clamp; undo for comparison.
    np.testing.assert_allclose(back ** 2, np.clip(img, 0, 1), atol=0.02)


def test_exr_roundtrip(tmp_path):
    img = (np.random.RandomState(1).rand(7, 9, 3) * 10).astype(np.float32)
    p = str(tmp_path / "t.exr")
    output.write_exr(p, img, aces=True)
    back = output._read_exr(p)
    np.testing.assert_allclose(back, img, atol=1e-6)


def test_pfm_hdr_roundtrip(tmp_path):
    img = (np.random.RandomState(2).rand(5, 6, 3) * 4).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    output.write_pfm(p, img)
    np.testing.assert_allclose(output._read_pfm(p), img, atol=1e-7)
    p2 = str(tmp_path / "t.hdr")
    output.write_hdr(p2, img)
    # RGBE keeps an 8-bit mantissa per pixel's brightest channel.
    np.testing.assert_allclose(output.read_image(p2), img,
                               atol=img.max() / 128)


def test_png_roundtrip_without_pil(tmp_path):
    """PNG write and read use only zlib/struct: both work in a process in
    which PIL cannot be imported."""
    p = str(tmp_path / "t.png")
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from izpi_tpu.io import output\n"
        "img = np.random.RandomState(5).rand(6, 7, 3)\n"
        f"output.write_png({p!r}, img)\n"
        f"back = output.read_image({p!r})\n"
        "q = np.round(np.sqrt(np.clip(img, 0, 1)) * 255) / 255\n"
        "assert back.shape == (6, 7, 3), back.shape\n"
        "assert np.abs(back - q).max() < 1e-6\n"
        "assert 'PIL' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]


def test_png_reader_filters(tmp_path):
    """Every PNG scanline filter (None, Sub, Up, Average, Paeth) decodes to
    the pixels it encoded."""
    rs = np.random.RandomState(6)
    h, w = 5, 4
    px = rs.randint(0, 256, size=(h, w, 3)).astype(np.int32)
    bpp, prev = 3, np.zeros(w * 3, np.int32)
    rows = []
    for y, ftype in enumerate([0, 1, 2, 3, 4]):
        cur = px[y].reshape(-1)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    p = tmp_path / "f.png"
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                  + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                  + chunk(b"IEND", b""))
    np.testing.assert_array_equal(
        np.round(output.read_image(str(p)) * 255).astype(np.int32), px)


def test_postprocess_pipeline():
    img = np.array([[[0.25, 4.0, -1.0]]])
    out = postprocess.Pipeline([postprocess.Gamma(), postprocess.Clamp()]) \
        .apply(img)
    np.testing.assert_allclose(out[0, 0], [0.5, 1.0, 0.0])


def test_cube_lut(tmp_path):
    # Identity 2-point LUT.
    cube = "LUT_3D_SIZE 2\n0 0 0\n1 0 0\n0 1 0\n1 1 0\n0 0 1\n1 0 1\n0 1 1\n1 1 1\n"
    p = str(tmp_path / "id.cube")
    open(p, "w").write(cube)
    lut = postprocess.ColourGrading.from_cube_file(p)
    img = np.random.RandomState(3).rand(4, 4, 3)
    np.testing.assert_allclose(lut.apply(img), img, atol=1e-12)


def test_scene_registry():
    from izpi_tpu.scene.library import REGISTRY, get_scene
    from izpi_tpu.scene.compiler import compile_scene

    assert len(REGISTRY) >= 8
    for name in ("random_scene", "two_spheres", "simple_light"):
        cs, meta = compile_scene(get_scene(name, aspect=1.0))
        assert meta.n_prims > 0


def test_cli_smoke(tmp_path):
    out = str(tmp_path / "o.png")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from izpi_tpu.cli import main;"
         f"main(['--scene','cornell_box','-x','16','-y','16',"
         f"'--samples','2','--sampler','colour','--max-depth','3',"
         f"'--output-file',r'{out}'])"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
    assert "Rendering completed" in r.stdout


def test_preview_server_serves_live_png(tmp_path):
    """Live display analog (internal/display): the preview server serves the
    progressive PNG and an auto-refresh page over HTTP."""
    import urllib.request

    import numpy as np

    from izpi_tpu.io import display as display_mod
    from izpi_tpu.io import output as output_mod

    path = str(tmp_path / "p.png")
    output_mod.write_png(path, np.full((4, 4, 3), 0.5, np.float32))
    srv = display_mod.PreviewServer(path, port=0).start()
    try:
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/", timeout=5).read()
        assert b"preview.png" in page
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/preview.png", timeout=5).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        # file updates are picked up (no caching)
        output_mod.write_png(path, np.zeros((4, 4, 3), np.float32))
        png2 = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/preview.png", timeout=5).read()
        assert png2 != png
    finally:
        srv.stop()


def _write_external_exr(path, planes, ptype, comp, lines_per_block=None):
    """Emulate an OIIO-style EXR: arbitrary channels (alphabetical),
    HALF/FLOAT, NONE/ZIPS/ZIP(16-line) compression — the file classes the
    reference loads via OpenImageIO (texture/image.go:31-59)."""
    import struct
    import zlib

    import numpy as np

    names = sorted(planes)
    h, w = planes[names[0]].shape
    dt = {1: np.float16, 2: np.float32}[ptype]
    lpb = lines_per_block or (16 if comp == 3 else 1)

    chan = b""
    for nm in names:
        chan += nm.encode() + b"\0" + struct.pack(
            "<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
    chan += b"\0"

    def attr(n, t, d):
        return n + b"\0" + t + b"\0" + struct.pack("<i", len(d)) + d

    header = attr(b"channels", b"chlist", chan)
    header += attr(b"compression", b"compression", struct.pack("B", comp))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += attr(b"dataWindow", b"box2i", box)
    header += attr(b"displayWindow", b"box2i", box)
    header += attr(b"lineOrder", b"lineOrder", struct.pack("B", 0))
    header += attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    def exr_zip(raw):
        data = np.frombuffer(raw, np.uint8)
        half = (len(data) + 1) // 2
        inter = np.empty(len(data), np.uint8)
        inter[0::2] = data[:half]
        inter[1::2] = data[half:]
        delta = np.empty(len(data), np.uint8)
        delta[0] = inter[0]
        delta[1:] = (inter[1:].astype(np.int16) - inter[:-1].astype(np.int16)
                     + 128).astype(np.uint8)
        out = zlib.compress(delta.tobytes())
        return out if len(out) < len(raw) else raw

    blocks = []
    y = 0
    while y < h:
        n_lines = min(lpb, h - y)
        raw = b""
        for ly in range(y, y + n_lines):
            for nm in names:
                raw += planes[nm][ly].astype(dt).tobytes()
        payload = exr_zip(raw) if comp in (2, 3) else raw
        blocks.append(struct.pack("<ii", y, len(payload)) + payload)
        y += n_lines

    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    base = len(magic) + len(header) + 8 * len(blocks)
    offsets, pos = [], base
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


def test_exr_half_zip16_roundtrip(tmp_path):
    """HALF pixels + real 16-scanline ZIP blocks + alpha channel + RGB in
    alphabetical (A,B,G,R) order — the natural shape of a downloaded HDRI."""
    import numpy as np

    from izpi_tpu.io import output

    rs = np.random.RandomState(3)
    img = (rs.rand(37, 23, 3) * 8).astype(np.float32)
    planes = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2],
              "A": np.ones_like(img[..., 0])}
    for ptype, comp, tol in ((1, 3, 4e-3), (2, 3, 0), (1, 2, 4e-3),
                             (2, 0, 0)):
        p = str(tmp_path / f"t_{ptype}_{comp}.exr")
        _write_external_exr(p, planes, ptype, comp)
        got = output.read_image(p)
        ref = img.astype(np.float16).astype(np.float32) if ptype == 1 else img
        np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


def test_exr_grayscale_y(tmp_path):
    import numpy as np

    from izpi_tpu.io import output

    y = np.linspace(0, 4, 5 * 7, dtype=np.float32).reshape(5, 7)
    p = str(tmp_path / "gray.exr")
    _write_external_exr(p, {"Y": y}, 2, 2)
    got = output.read_image(p)
    for c in range(3):
        np.testing.assert_allclose(got[..., c], y)


def test_exr_piz_clear_error(tmp_path):
    import numpy as np
    import pytest

    from izpi_tpu.io import output

    img = np.zeros((4, 4), np.float32)
    p = str(tmp_path / "piz.exr")
    _write_external_exr(p, {"R": img, "G": img, "B": img}, 2, 0)
    # flip the compression byte to PIZ (4) in place
    data = bytearray(open(p, "rb").read())
    i = data.index(b"compression\0compression\0")
    data[i + len(b"compression\0compression\0") + 4] = 4
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="PIZ"):
        output.read_image(p)


def test_exr_writer_declares_zips(tmp_path):
    """The writer emits one-scanline chunks, so it must declare ZIPS (2),
    not ZIP (3, 16-line chunks) — standard readers misparse otherwise."""
    import numpy as np

    from izpi_tpu.io import output

    img = np.random.RandomState(0).rand(9, 6, 3).astype(np.float32)
    p = str(tmp_path / "w.exr")
    output.write_exr(p, img)
    data = open(p, "rb").read()
    i = data.index(b"compression\0compression\0")
    assert data[i + len(b"compression\0compression\0") + 4] == 2
    np.testing.assert_allclose(output.read_image(p), img)
