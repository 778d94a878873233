"""The demo twin `app_torch.py` on the CPU: its stdlib server on port 0 in
a thread, on a wrapper with the tiny towers of `tests/test_torch_cli.py`:
the form page, a POST of two photos (a PNG and a JPEG) answered with the
asked number of inline PNGs, and a POST whose photo has no face answered
with 500 and the message. The multipart body is parsed without `cgi`."""

import base64
import http.client
import pathlib
import re
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.utils.image import decode_png, encode_png
from tests.test_torch_cli import HW, _common_args, cli  # noqa: F401 (fixture)
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
BOUNDARY = "----adaface-test-boundary"


def multipart(files: list[tuple[str, bytes]], fields: dict) -> bytes:
    parts = []
    for name, data in files:
        parts.append(f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="images"; '
                     f'filename="{name}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                     .encode() + data + b"\r\n")
    for k, v in fields.items():
        parts.append(f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
                     f"{v}\r\n".encode())
    return b"".join(parts) + f"--{BOUNDARY}--\r\n".encode()


@pytest.fixture()
def server(cli, monkeypatch):  # noqa: F811
    monkeypatch.syspath_prepend(str(REPO))
    import app_torch

    common, _ = cli
    wrapper = common.build_wrapper(_common_args(common, "cpu"), "text2img")
    wrapper.id2ada_prompt_encoder.face_backend = DeterministicBackend(always_detect=False)
    srv = app_torch.make_server(app_torch.DemoBackend(wrapper, 2, size=HW), 0, "127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    thread.join()


def request(port: int, method: str, body: bytes = b"") -> tuple[int, str]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    headers = {"Content-Type": f"multipart/form-data; boundary={BOUNDARY}"} if body else {}
    conn.request(method, "/generate" if method == "POST" else "/", body=body, headers=headers)
    resp = conn.getresponse()
    out = resp.status, resp.read().decode()
    conn.close()
    return out


def test_app_serves_the_form_and_images(server, tmp_path):
    status, page = request(server, "GET")
    assert status == 200 and "enctype=multipart/form-data" in page
    assert all(f"<option>{s}</option>" in page for s in ("photorealistic", "realistic", "anime"))
    rs = np.random.RandomState(0)
    Image.fromarray(rs.randint(0, 256, (40, 48, 3)).astype(np.uint8)).save(tmp_path / "b.jpg")
    photos = [("a.png", encode_png(rs.randint(0, 256, (32, 32, 3)).astype(np.uint8))),
              ("b.jpg", (tmp_path / "b.jpg").read_bytes()), ("empty.png", b"")]
    status, page = request(server, "POST", multipart(photos, {
        "prompt": "portrait at the beach", "style": "anime", "n": "2", "gs": "4.0"}))
    assert status == 200, page
    assert re.search(r"<h3>seed \d+</h3>", page)
    pngs = re.findall(r'<img src="data:image/png;base64,([^"]+)">', page)
    assert len(pngs) == 2
    for b64 in pngs:
        img = decode_png(base64.b64decode(b64))
        assert img.shape == (HW, HW, 3) and img.dtype == np.uint8 and img.std() > 0


def test_app_without_a_face_returns_500(server):
    black = encode_png(np.zeros((16, 16, 3), np.uint8))
    status, page = request(server, "POST", multipart([("black.png", black)], {"prompt": "x"}))
    assert status == 500
    assert "<pre>error: no face detected in the uploaded images</pre>" in page
    status, page = request(server, "POST", multipart([("x.gif", b"GIF89a....")], {"n": "1"}))
    assert status == 500 and "upload 0" in page and "GIF: file ends inside the header" in page


def test_app_parses_without_cgi():
    sys.modules.pop("cgi", None)
    import app_torch

    files, fields = app_torch.parse_multipart(f"multipart/form-data; boundary={BOUNDARY}",
                                              multipart([("a.png", b"\x89PNG-bytes")],
                                                        {"prompt": "héllo", "n": "3"}))
    assert files == [b"\x89PNG-bytes"] and fields == {"prompt": "héllo", "n": "3"}
    assert "cgi" not in sys.modules
