"""The port's web server (``python -m yume_tpu_torch.serving.webapp``) on
the CPU, the flow of ``tests/test_webapp.py``: load → t2v → continue_from_last
→ i2v upload → a two-segment request → video download and log tail, with
``--memory_optimization`` host offload on, then the refine endpoint and the
bilingual index page. The smoke config in fp32; the server runs in a thread
on port 0.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from torch_parity import torch_threads
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
from yume_tpu_torch.serving import webapp
from yume_tpu_torch.utils.offload import OffloadSlot


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _wait_done(port, timeout=120):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = _get(port, "/api/status")
        if st["status"] in ("done", "error"):
            return st
        time.sleep(0.2)
    raise TimeoutError("generation did not finish")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    out = tmp_path_factory.mktemp("web_out")
    args = webapp.build_argparser().parse_args(
        ["--smoke", "--memory_optimization", "--device", "cpu", "--output_dir", str(out)])
    app = webapp.WebApp(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), app.handler())
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    with torch_threads(2):
        yield srv.server_address[1], app
    srv.shutdown()
    srv.server_close()
    app.close()
    t.join(timeout=10)
    assert not t.is_alive()


def _png_b64():
    from PIL import Image

    img = Image.fromarray((np.random.default_rng(0).random((32, 32, 3)) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_full_session_flow(server, monkeypatch):
    port, app = server
    moves, phases = [], []
    real = TI2VPipeline.generate_segment
    real_use, real_park = OffloadSlot.use, OffloadSlot.park

    def spy(self, *a, **kw):
        # under memory_optimization the DiT runs with umT5 and the VAE parked
        phases.append((moves[-1], kw["progress_cb"] is not None))
        return real(self, *a, **kw)

    monkeypatch.setattr(TI2VPipeline, "generate_segment", spy)
    monkeypatch.setattr(OffloadSlot, "use",
                        lambda slot, name: moves.append(name) or real_use(slot, name))
    monkeypatch.setattr(OffloadSlot, "park",
                        lambda slot, keep=None: moves.append(keep) or real_park(slot, keep))
    with pytest.raises(urllib.error.HTTPError) as refused:
        _post(port, "/api/generate_long", {"mode": "t2v"})
    assert refused.value.code == 409
    assert _post(port, "/api/load", {})["status"] == "loaded"
    assert app.slot is not None and "t5" in app.slot and "vae" in app.slot

    r = _post(port, "/api/generate_long", {"mode": "t2v", "keys": "W", "mouse": "·",
                                           "steps": 2})
    assert r["status"] == "started"
    st = _wait_done(port)
    assert st["status"] == "done", st
    assert len(st["outputs"]) == 1 and st["has_session"] is True

    # continue_from_last reuses the session latents
    last = app.last
    _post(port, "/api/generate_long", {"mode": "continue_from_last", "keys": "D",
                                       "mouse": "→", "steps": 2})
    st = _wait_done(port)
    assert st["status"] == "done", st
    assert len(st["outputs"]) == 2
    assert app.last.shape[1] == last.shape[1] + 2
    # per-step progress was exposed
    assert st["step"]["n"] == 2 and st["step"]["i"] == 2 and st["step"]["segment"] >= 1

    # i2v upload
    _post(port, "/api/generate_long", {"mode": "i2v", "image_b64": _png_b64(), "steps": 2,
                                       "prompt": "Person moves forward (W)."})
    st = _wait_done(port)
    assert st["status"] == "done", st
    assert len(st["outputs"]) == 3

    # a two-segment request
    _post(port, "/api/generate_long", {"mode": "continue_from_last", "steps": 2,
                                       "segments": 2})
    st = _wait_done(port)
    assert st["status"] == "done", st
    assert len(st["outputs"]) == 5
    assert phases == [(None, True)] * 4      # t2v's first segment is generate_t2v
    assert "t5" in moves and "vae" in moves

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/video/0", timeout=60) as vr:
        assert vr.headers["Content-Type"] == "video/mp4"
        assert len(vr.read()) > 0
    logs = _get(port, "/api/log/tail")
    assert any("generated" in line for line in logs["lines"])


def test_quant_int4_request(tmp_path, monkeypatch):
    """``--quant int4``: the first request quantizes the trunk, and its t2v
    first segment and continuation both run on it (2 steps each)."""
    import os

    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.models.quantized import is_quantized

    calls = []
    real = WanDiT.forward

    def spy(self, x, *a, **kw):
        if is_quantized(self):
            calls.append(x.shape)
        return real(self, x, *a, **kw)

    monkeypatch.setattr(WanDiT, "forward", spy)
    args = webapp.build_argparser().parse_args(
        ["--smoke", "--device", "cpu", "--quant", "int4", "--output_dir", str(tmp_path)])
    app = webapp.WebApp(args)
    try:
        with torch_threads(2):
            app.load_models()
            assert not is_quantized(app.pipe.dit)
            app._generate({"mode": "t2v", "steps": 2, "segments": 2, "seed": 1})
        assert app.status == "done", app.progress
        assert app.pipe.dit.quant_bits == 4 and len(calls) == 4
        assert len(app.outputs) == 2 and all(os.path.getsize(p) > 0 for p in app.outputs)
    finally:
        app.close()


def test_refine_endpoint(server):
    port, _ = server
    r = _post(port, "/api/refine_prompt",
              {"prompt": "Person moves forward (W).", "image_b64": _png_b64()})
    assert r["prompt"].startswith("This video depicts a city walk scene")
    assert r["prompt"].endswith("(W).")


def test_index_ui_bilingual(server):
    port, _ = server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60) as r:
        html = r.read().decode()
    for marker in ("I18N", "交互式世界生成", "interactive world generation",
                   "/api/generate_long", "/api/refine_prompt", "/api/log/tail",
                   "/api/status", "continue_from_last", "image_b64"):
        assert marker in html, marker


def test_status_reads_generating_once_started(server, monkeypatch):
    """A status poll right after ``started`` reads ``generating``, however
    late the request's thread gets going (a client that polled until the
    status left ``generating`` read the previous request's ``loaded`` or
    ``done`` when it polled first)."""
    port, app = server
    assert _post(port, "/api/load", {})["status"] in ("loaded", "done")
    before, go = app.status, threading.Event()
    monkeypatch.setattr(app, "_generate", lambda req: go.wait(timeout=60))
    try:
        assert _post(port, "/api/generate_long", {"mode": "t2v"})["status"] == "started"
        assert _get(port, "/api/status")["status"] == "generating"
    finally:
        go.set()
        assert app.lock.acquire(timeout=60)
        app.lock.release()
        app.status = before
