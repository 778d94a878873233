"""Make the GIF fixtures of `tests/data/images/` and record the SHA-256 of
the frames Pillow decodes from them (`gif_digests.json`).

    python tests/make_gif_fixtures.py

Pillow writes all but the first, which `adaface_tpu_torch.utils.image.
write_gif` (the video pipeline's writer) writes:
- `port_video.gif`: 12 frames of a moving gradient on the writer's palette;
- `local_palettes.gif`: frames quantized each to its own palette, so every
  frame after the first carries a local colour table;
- `transparency_disposal.gif`: frames of a partly transparent sprite with
  disposal methods 2 and 3 and a transparent index;
- `interlaced.gif`: one interlaced frame;
- `codes_12bit.gif`: noise on 256 colours, whose LZW codes reach 12 bits.
`tests/test_torch_gif.py` holds the port's decoder to these digests and to
Pillow; `gif_blocks` and `lzw_code_widths` read the files' structure so that
the tests and this script can check what each fixture holds.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "images")
DIGESTS = "gif_digests.json"


def gif_blocks(data: bytes) -> list[dict]:
    """The frames of a GIF as its blocks give them: each frame's graphic
    control (transparent index or None, disposal bits), interlace flag,
    local palette size (0 if none) and LZW data (minimum code size, the
    sub-blocks joined)."""
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames, gce = [], (None, 0)

    def sub_blocks(pos):
        out = bytearray()
        while data[pos]:
            out += data[pos + 1:pos + 1 + data[pos]]
            pos += 1 + data[pos]
        return bytes(out), pos + 1

    while pos < len(data) and data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            label = data[pos + 1]
            body, pos = sub_blocks(pos + 2)
            if label == 0xF9:
                gce = (body[3] if body[0] & 1 else None, (body[0] >> 2) & 7)
        elif kind == 0x2C:
            iflags = data[pos + 9]
            pos += 10
            local = 3 << ((iflags & 7) + 1) if iflags & 0x80 else 0
            pos += local
            min_code = data[pos]
            lzw, pos = sub_blocks(pos + 1)
            frames.append(dict(transparency=gce[0], disposal=gce[1],
                               interlace=bool(iflags & 0x40), local_palette=local // 3,
                               min_code=min_code, lzw=lzw))
            gce = (None, 0)
        else:
            pos += 1
    return frames


def lzw_code_widths(min_code: int, lzw: bytes) -> set[int]:
    """The code widths an LZW stream is read at (clear codes reset them)."""
    bits = np.unpackbits(np.frombuffer(lzw, np.uint8), bitorder="little")
    clear = 1 << min_code
    size, nxt, pos, prev, widths = min_code + 1, clear + 2, 0, None, set()
    while pos + size <= len(bits):
        code = int(bits[pos:pos + size] @ (1 << np.arange(size)))
        widths.add(size)
        pos += size
        if code == clear:
            size, nxt, prev = min_code + 1, clear + 2, None
            continue
        if code == clear + 1:
            break
        if prev is not None and nxt < 4096:
            nxt += 1
            if nxt == 1 << size and size < 12:
                size += 1
        prev = code
    return widths


def pil_frames(path: str) -> np.ndarray:
    """Pillow's RGB frames of a GIF, [F, H, W, 3]."""
    from PIL import Image

    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
    return np.stack(out)


def _gradient(h: int, w: int, shift: float) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 127.5 + 127.5 * np.sin(x / 5.0 + shift)
    g = 127.5 + 127.5 * np.cos(y / 7.0 - 0.5 * shift)
    b = (x + y + 9 * shift) % 256
    return np.stack([r, g, b], -1).astype(np.uint8)


def _save(frames, path: str, **kw) -> None:
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=100, loop=0, **kw)


def make(out: str = OUT) -> dict:
    """Write the fixtures into `out` → {name: {"shape", "sha256"}}."""
    from PIL import Image

    from adaface_tpu_torch.utils.image import write_gif

    os.makedirs(out, exist_ok=True)
    rs = np.random.RandomState(0)
    paths = {}

    paths["port_video.gif"] = p = os.path.join(out, "port_video.gif")
    write_gif(p, np.stack([_gradient(40, 48, 0.6 * i) for i in range(12)]), fps=8)

    paths["local_palettes.gif"] = p = os.path.join(out, "local_palettes.gif")
    tints = [(1.0, 0.3, 0.2), (0.2, 1.0, 0.4), (0.3, 0.3, 1.0), (1.0, 1.0, 0.1)]
    frames = [Image.fromarray((_gradient(20, 24, i) * np.array(t)).astype(np.uint8))
              .quantize(colors=16 + 8 * i, method=Image.Quantize.MEDIANCUT)
              for i, t in enumerate(tints)]
    _save(frames, p, interlace=False, optimize=False)

    paths["transparency_disposal.gif"] = p = os.path.join(out, "transparency_disposal.gif")
    pal = rs.randint(0, 256, (16, 3)).astype(np.uint8)
    frames = []
    for i in range(5):
        idx = np.zeros((24, 32), np.uint8)  # index 0: transparent
        idx[4 + i:14 + i, 3 + 4 * i:13 + 4 * i] = 1 + (i % 15)
        idx[18:, 2 * i:2 * i + 6] = 7 + i
        im = Image.fromarray(idx, "P")
        im.putpalette(pal.ravel().tolist())
        frames.append(im)
    _save(frames, p, transparency=0, disposal=[2, 3, 2, 3, 2], interlace=False, optimize=False)

    # Pillow interlaces a single frame only (its frames after the first are
    # written without the flag)
    paths["interlaced.gif"] = p = os.path.join(out, "interlaced.gif")
    Image.fromarray(_gradient(37, 29, 1.3)).quantize(colors=64).save(p, interlace=True)

    paths["codes_12bit.gif"] = p = os.path.join(out, "codes_12bit.gif")
    pal = rs.randint(0, 256, (256, 3)).astype(np.uint8)
    frames = []
    for i in range(2):
        im = Image.fromarray(rs.randint(0, 256, (64, 80)).astype(np.uint8), "P")
        im.putpalette(pal.ravel().tolist())
        frames.append(im)
    _save(frames, p, interlace=False, optimize=False)

    digests = {}
    for name, path in sorted(paths.items()):
        px = pil_frames(path)
        digests[name] = {"shape": list(px.shape),
                         "sha256": hashlib.sha256(px.tobytes()).hexdigest()}
    return digests


def check(out: str = OUT) -> None:
    """What each fixture must hold for its test to mean anything."""
    def blocks(name):
        with open(os.path.join(out, name), "rb") as f:
            return gif_blocks(f.read())

    assert all(f["local_palette"] for f in blocks("local_palettes.gif")[1:])
    tb = blocks("transparency_disposal.gif")
    assert {f["disposal"] for f in tb} >= {2, 3} and all(f["transparency"] is not None
                                                          for f in tb)
    assert all(f["interlace"] for f in blocks("interlaced.gif"))
    assert 12 in lzw_code_widths(blocks("codes_12bit.gif")[0]["min_code"],
                                 blocks("codes_12bit.gif")[0]["lzw"])


if __name__ == "__main__":
    digests = make()
    check()
    with open(os.path.join(OUT, DIGESTS), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(digests, indent=1))
