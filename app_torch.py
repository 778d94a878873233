"""The AdaFace demo on the PyTorch port (the twin of `app.py`'s stdlib
server, `app.py:83-148`).

    python app_torch.py [--port 7860] [--base_model ...] [--adaface_ckpt ...] [--device cpu]

A page with a form: subject photos (PNG, JPEG or BMP), a prompt, a style
(a prompt prefix), a count and a guidance scale. POST /generate returns a
page with the seed and the generated images as inline PNGs; a failure (no
face in the photos, an unreadable file) returns 500 with the message. The
multipart body is parsed with `email.parser` (no `cgi`), photos are
decoded by the port's host library and images encoded by
`utils.image.encode_png`: neither PIL nor gradio is needed. The wrapper
runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import base64
import os
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

MODEL_STYLES = {
    # the reference demo's model-style selector (`app.py:40-80`); styles
    # are prompt prefixes until style checkpoints are mounted
    "photorealistic": "photorealistic, sharp focus, ",
    "realistic": "realistic, natural skin texture, ",
    "anime": "anime illustration style, ",
}

PAGE = """<!doctype html><title>AdaFace</title>
<h2>AdaFace demo</h2>
<form method=post enctype=multipart/form-data action=/generate>
 Subject photos: <input type=file name=images multiple><br>
 Prompt: <input name=prompt size=60 value="portrait at the beach"><br>
 Style: <select name=style>%s</select>
 Count: <input name=n value=2 size=3>
 Guidance: <input name=gs value=5.0 size=4><br>
 <input type=submit value=Generate></form>""" % "".join(
    f"<option>{s}</option>" for s in MODEL_STYLES)


class DemoBackend:
    """Photos and a prompt → `size`² images, on an `AdaFaceWrapper`
    ("text2img")."""

    def __init__(self, wrapper, num_inference_steps: int, size: int = 512):
        self.wrapper = wrapper
        self.num_inference_steps = num_inference_steps
        self.size = size

    def generate(self, images: list[np.ndarray], prompt: str, style: str = "photorealistic",
                 num_images: int = 2, guidance_scale: float = 5.0,
                 seed: int | None = None) -> tuple[list[np.ndarray], int]:
        """→ ([H, W, 3] uint8 images, the seed); ValueError without a face."""
        ada = self.wrapper.prepare_adaface_embeddings(images=images)
        if ada is None:
            raise ValueError("no face detected in the uploaded images")
        seed = seed if seed is not None else int.from_bytes(os.urandom(2), "little")
        device = self.wrapper.pipeline.m.device
        out = self.wrapper.forward(MODEL_STYLES.get(style, "") + prompt, num_images=num_images,
                                   guidance_scale=guidance_scale,
                                   num_inference_steps=self.num_inference_steps,
                                   height=self.size, width=self.size,
                                   generator=torch.Generator(device).manual_seed(seed))
        arr = (out.float().cpu().numpy() * 255).astype(np.uint8).transpose(0, 2, 3, 1)
        return list(arr), seed


def parse_multipart(content_type: str, body: bytes) -> tuple[list[bytes], dict[str, str]]:
    """A multipart/form-data body → (the uploaded files' bytes, the other
    fields as text); empty file inputs are dropped."""
    from email.parser import BytesParser
    from email.policy import default as default_policy

    msg = BytesParser(policy=default_policy).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    files, fields = [], {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        payload = part.get_payload(decode=True) or b""
        if part.get_filename() is not None:
            if payload:
                files.append(payload)
        else:
            fields[name] = payload.decode()
    return files, fields


def make_handler(backend: DemoBackend):
    from adaface_tpu_torch.utils.image import decode_image_bytes, encode_png, to_rgb

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, html: str) -> None:
            body = html.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._send(200, PAGE)

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            try:
                files, fields = parse_multipart(self.headers["Content-Type"], body)
                imgs = [to_rgb(decode_image_bytes(f, f"upload {i}")) for i, f in enumerate(files)]
                outs, seed = backend.generate(
                    imgs, fields.get("prompt", ""), fields.get("style", "photorealistic"),
                    int(fields.get("n", 2)), float(fields.get("gs", 5.0)))
                tags = "".join(f'<img src="data:image/png;base64,'
                               f'{base64.b64encode(encode_png(a)).decode()}">' for a in outs)
                self._send(200, f"<h3>seed {seed}</h3>{tags}<p><a href=\"/\">back</a></p>")
            except Exception as e:  # surfacing errors in the UI
                self._send(500, f"<pre>error: {e}</pre><a href='/'>back</a>")

        def log_message(self, fmt, *args):
            sys.stderr.write(f"app_torch: {fmt % args}\n")

    return Handler


def make_server(backend: DemoBackend, port: int, host: str = "0.0.0.0") -> HTTPServer:
    """The demo's HTTP server on (host, port); port 0 takes a free one
    (`server.server_address`)."""
    return HTTPServer((host, port), make_handler(backend))


def main(argv=None) -> None:
    from _common_torch import add_model_args, build_wrapper

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(ap)
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args(argv)
    backend = DemoBackend(build_wrapper(args, "text2img"), min(args.num_inference_steps, 50))
    server = make_server(backend, args.port)
    print(f"AdaFace demo at http://0.0.0.0:{server.server_address[1]} (stdlib server)")
    server.serve_forever()


if __name__ == "__main__":
    main()
