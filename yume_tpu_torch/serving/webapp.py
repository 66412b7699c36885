"""Interactive world-generation web server for the 5B model (counterpart
of yume_tpu/serving/webapp.py, the reference's single-GPU Flask webapp).

    python -m yume_tpu_torch.serving.webapp --preload                      # 5B on the card
    python -m yume_tpu_torch.serving.webapp --smoke --device cpu --port 7860

REST endpoints /api/load, /api/generate_long (modes ``t2v``, ``i2v`` with
an uploaded image, ``continue_from_last``, and a number of ``segments``),
/api/status, /api/refine_prompt, /api/log/tail and /video/<i>; the
keyboard/mouse control vocabulary becomes the caption. Built on the stdlib
``http.server``; generation runs on a worker thread, one request at a
time, and the page polls its status and per-step progress.

The server's state lives in a :class:`WebApp`, which
:meth:`WebApp.handler` binds to a request handler class. Frames wider than
40 latent columns decode width-tiled (``TI2VPipeline.decode_tiled``).
``--memory_optimization`` keeps umT5 and the VAE in host memory, each on
the device only for its phase. The log goes to ``<output_dir>/webapp.log``.

Not ported, and refused with the ROADMAP queue 1 item that brings them:
``--quant int8|int4`` (item 6, ``models/quantized.py``), ``--pp`` (item 8)
and ``--sp > 1`` (a CLI launch of the SP groups, item 4).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

# Bilingual (EN/中文) single-page UI over the REST endpoints: mode select,
# image upload, prompt + refine, camera vocabulary, per-step progress, log
# tail, video gallery.
INDEX_HTML = """<!doctype html><html><head><meta charset=utf-8>
<title>Yume</title><style>
body{font-family:sans-serif;max-width:860px;margin:1.5em auto;padding:0 1em}
fieldset{border:1px solid #ccc;border-radius:6px;margin:.6em 0}
button{margin:2px;padding:.35em .9em}video{max-width:100%;margin:.4em 0}
textarea{width:100%;box-sizing:border-box}label{margin-right:.8em}
#bar{height:10px;background:#eee;border-radius:5px;overflow:hidden}
#fill{height:100%;width:0;background:#4a7;transition:width .3s}
#log{background:#111;color:#9e9;padding:.5em;font-size:11px;max-height:160px;
overflow:auto;white-space:pre-wrap}.muted{color:#777;font-size:12px}
</style></head><body>
<div style="float:right"><button onclick="setLang('en')">EN</button>
<button onclick="setLang('zh')">中文</button></div>
<h2 data-i18n=title></h2>
<fieldset><legend data-i18n=model></legend>
<button onclick="loadModel()" data-i18n=load></button>
<span id=loadstate class=muted></span></fieldset>
<fieldset><legend data-i18n=controls></legend>
<label data-i18n=mode></label><select id=mode>
<option value=t2v data-i18n=m_t2v></option>
<option value=i2v data-i18n=m_i2v></option>
<option value=continue_from_last data-i18n=m_cont></option></select>
<label data-i18n=keys></label><select id=keys><option>W</option><option>A</option>
<option>S</option><option>D</option><option>W+A</option><option>W+D</option>
<option>S+A</option><option>S+D</option><option>None</option></select>
<label data-i18n=mouse></label><select id=mouse><option>·</option><option>→</option>
<option>←</option><option>↑</option><option>↓</option><option>↑→</option>
<option>↑←</option><option>↓→</option><option>↓←</option></select>
<label data-i18n=steps></label><input id=steps type=number value=4 min=1 max=50
 style="width:4em">
<label data-i18n=segments></label><input id=segments type=number value=1 min=1
 max=8 style="width:4em">
<label>seed</label><input id=seed type=number value=0 style="width:6em">
</fieldset>
<fieldset><legend data-i18n=prompt></legend>
<textarea id=prompt rows=3></textarea>
<input id=img type=file accept="image/*">
<button onclick="refine()" data-i18n=refine></button>
<label><input id=autorefine type=checkbox> <span data-i18n=autorefine></span></label>
</fieldset>
<p><button onclick="gen()" style="font-size:1.1em" data-i18n=generate></button>
<span id=prog class=muted></span></p>
<div id=bar><div id=fill></div></div>
<div id=out></div>
<details><summary data-i18n=logs></summary><div id=log></div></details>
<script>
const I18N={en:{title:'Yume — interactive world generation',
 model:'Model',load:'Load model',controls:'Camera / sampling controls',
 mode:'mode:',m_t2v:'text → video',m_i2v:'image → video',
 m_cont:'continue last',keys:'keys:',mouse:'mouse:',steps:'steps:',
 segments:'segments:',prompt:'Prompt',refine:'Refine prompt',
 autorefine:'refine before generating',generate:'Generate',logs:'Server log'},
zh:{title:'Yume — 交互式世界生成',model:'模型',load:'加载模型',
 controls:'相机 / 采样控制',mode:'模式：',m_t2v:'文生视频',
 m_i2v:'图生视频',m_cont:'继续上一段',keys:'按键：',mouse:'鼠标：',
 steps:'步数：',segments:'段数：',prompt:'提示词',refine:'润色提示词',
 autorefine:'生成前自动润色',generate:'开始生成',logs:'服务器日志'}};
function setLang(l){localStorage.lang=l;
 document.querySelectorAll('[data-i18n]').forEach(e=>{
  e.textContent=I18N[l][e.dataset.i18n]||e.textContent;});}
async function imgB64(){const f=document.getElementById('img').files[0];
 if(!f)return null;const b=await f.arrayBuffer();
 return btoa(String.fromCharCode(...new Uint8Array(b)));}
async function loadModel(){document.getElementById('loadstate').textContent='...';
 await fetch('/api/load',{method:'POST',body:'{}'});
 document.getElementById('loadstate').textContent='ok';}
async function refine(){const body={prompt:document.getElementById('prompt').value,
 image_b64:await imgB64()};
 const r=await fetch('/api/refine_prompt',{method:'POST',
  headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
 const j=await r.json();
 if(j.prompt)document.getElementById('prompt').value=j.prompt;}
async function gen(){
 const body={mode:document.getElementById('mode').value,
  keys:document.getElementById('keys').value,
  mouse:document.getElementById('mouse').value,
  prompt:document.getElementById('prompt').value||undefined,
  steps:+document.getElementById('steps').value,
  segments:+document.getElementById('segments').value,
  seed:+document.getElementById('seed').value,
  refine_prompt:document.getElementById('autorefine').checked||undefined,
  image_b64:await imgB64()};
 await fetch('/api/generate_long',{method:'POST',
  headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
 poll();}
async function poll(){
 const r=await fetch('/api/status');const j=await r.json();
 document.getElementById('prog').textContent=j.progress||j.status;
 const s=j.step||{};const pct=s.n?Math.round(100*((s.segment||0)*s.n+s.i)/
  ((s.segments||1)*s.n)):0;
 document.getElementById('fill').style.width=pct+'%';
 try{const lr=await fetch('/api/log/tail?n=30');const lj=await lr.json();
  document.getElementById('log').textContent=(lj.lines||[]).join('\\n');}catch(e){}
 if(j.status=='generating'){setTimeout(poll,1000);}
 else if(j.outputs&&j.outputs.length){
  document.getElementById('out').innerHTML=j.outputs.map((_,i)=>
   '<video controls src="/video/'+i+'"></video>').reverse().join('');}}
setLang(localStorage.lang||'en');poll();
</script></body></html>"""


class WebApp:
    """The server's state: the pipeline, the session's last latents, the
    request status and the outputs. One generation runs at a time."""

    def __init__(self, args):
        from ..sample import refuse_unported, teacache_settings

        refuse_unported(args, webapp=True)
        if args.refiner_model:
            from ..data.prompt_refine import get_refiner

            get_refiner(args.refiner_model)   # raises: only the template refiner is ported
        self.args = args
        self.teacache = teacache_settings(args) if args.teacache else (3, None)
        self.pipe = self.cfg = self.tokenizer = self.slot = None
        self.status, self.progress, self.step = "idle", "", None
        self.last = None          # session state: latents of the last generation
        self.outputs = []
        self.lock = threading.Lock()
        os.makedirs(args.output_dir, exist_ok=True)
        self.log_path = os.path.join(args.output_dir, "webapp.log")
        self.log = logging.Logger("yume_tpu_torch.webapp")
        self._log_file = logging.FileHandler(self.log_path)
        self._log_file.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        self.log.addHandler(self._log_file)

    def close(self):
        """Close the log file."""
        self.log.removeHandler(self._log_file)
        self._log_file.close()

    def handler(self):
        """A request handler class bound to this app."""
        return type("BoundHandler", (Handler,), {"app": self})

    def load_models(self):
        from ..data.tokenizer import Tokenizer, resolve_tokenizer_path
        from ..sample import load_pipeline
        from ..utils.offload import OffloadSlot

        args = self.args
        self.cfg, self.pipe = load_pipeline(args)
        if args.memory_optimization:
            # umT5 and the VAE wait in host memory; the DiT stays resident
            self.slot = OffloadSlot(self.pipe.device)
            self.slot.register("t5", self.pipe.t5)
            self.slot.register("vae", self.pipe.vae)
        self.tokenizer = Tokenizer(resolve_tokenizer_path(args.tokenizer, args.ckpt_dir),
                                   seq_len=self.cfg.t5.text_len,
                                   vocab_size=self.cfg.t5.vocab_size,
                                   warn_fallback=not args.smoke)
        self.status = "loaded"
        self.log.info("models loaded (%s, smoke=%s, device=%s)", args.config, args.smoke,
                      args.device)

    def _phase(self, name):
        """Bring the model of phase ``name`` ('t5', 'vae' or 'dit') onto the
        device and park the others (a no-op without memory_optimization)."""
        if self.slot is None:
            return
        if name == "dit":
            self.slot.park()
        else:
            self.slot.use(name)

    def refine_prompt(self, prompt, image=None):
        """The template refiner (the reference's fallback; its model-backed
        refiners are not ported)."""
        from ..data.prompt_refine import TemplateRefiner

        return TemplateRefiner()(prompt, image)

    def _generate(self, req):
        from ..data.controls import control_caption
        from ..utils.video import load_image, save_video

        args, pipe, cfg = self.args, self.pipe, self.cfg
        lfz = cfg.latent_frame_zero
        mode = req.get("mode", "t2v")
        prompt = req.get("prompt") or control_caption(req.get("keys", "W"),
                                                      req.get("mouse", "·"))
        steps = int(req.get("steps", 2 if args.smoke else 4))
        seed = int(req.get("seed", int(time.time()) % 100000))
        # continuation segments in this request (the reference's long_generate loop)
        segments = max(1, int(req.get("segments", 1)))

        self.status = "generating"
        self.step = {"i": 0, "n": steps, "segment": 0, "segments": segments}
        self.progress = f"mode={mode} prompt={prompt[:60]}"
        t0 = time.time()

        img = None
        if req.get("image_b64"):
            size = (32, 32) if args.smoke else (args.height, args.width)
            img = load_image(io.BytesIO(base64.b64decode(req["image_b64"])), size=size)
        if req.get("refine_prompt"):
            prompt = self.refine_prompt(prompt, img)
            self.progress = f"refined: {prompt[:60]}"

        self._phase("t5")
        ctx = pipe.encode_text(*self.tokenizer([prompt]))

        def on_step(t):
            self.step["i"] += 1
            s = self.step
            self.progress = (f"segment {s['segment'] + 1}/{s['segments']} "
                             f"step {s['i']}/{s['n']} t={t:.1f}")

        def decode(tail):
            self._phase("vae")
            # width tiles bound the decode's memory at 720p-class frames
            video = pipe.decode_tiled(tail) if tail.shape[3] >= 40 else pipe.decode_auto(tail)
            return video[0].float().cpu().numpy()

        videos = []
        if mode == "continue_from_last" and self.last is not None:
            latents = self.last
        elif mode == "i2v" and img is not None:
            self._phase("vae")
            frames = torch.from_numpy(np.repeat(img[None], 16, 0))[None].to(pipe.device)
            frame_num = 5 if args.smoke else cfg.frame_num
            z, _ = pipe.encode_image_conditioning(frames, frame_num)
            latents = z[:, :-lfz]
        else:  # t2v first segment
            size = (32, 32) if args.smoke else (args.width, args.height)
            frame_num = 5 if args.smoke else cfg.frame_num
            self._phase("dit")
            latents = pipe.generate_t2v(ctx, size=size, frame_num=frame_num, steps=steps,
                                        seed=seed, return_latents=True)
            self.step["i"] = steps
            videos.append(decode(latents))
            segments -= 1
            self.step["segment"] += 1

        interval, threshold = self.teacache
        for s_idx in range(segments):
            self._phase("dit")
            self.step["i"] = 0
            latents = pipe.generate_segment(
                latents, ctx, steps=steps, seed=seed + s_idx,
                sampler="teacache" if args.teacache else "euler",
                teacache_interval=interval, teacache_threshold=threshold,
                progress_cb=None if args.teacache else on_step)
            if args.teacache:
                # the cached sampler reports no steps: per-segment progress
                self.step["i"] = steps
                self.progress = f"segment {self.step['segment'] + 1}: denoised, decoding"
            videos.append(decode(latents[:, -lfz:]))
            self.step["segment"] += 1

        self.last = latents
        outs = []
        for video in videos:
            out = os.path.join(args.output_dir, f"web_{len(self.outputs):04d}.mp4")
            written = save_video(video, out, fps=cfg.sample_fps)
            self.outputs.append(written)
            outs.append(written)
        self.status = "done"
        self.progress = f"{time.time() - t0:.1f}s → {', '.join(outs)}"
        self.log.info("generated %s in %.1fs", outs, time.time() - t0)

    def generate(self, req):
        """Run one request (the lock held by the caller); a failure becomes
        the status ``error`` with its message, and the log gets its
        traceback."""
        try:
            self._generate(req)
        except Exception as e:  # noqa: the server keeps serving after a failed request
            self.status = "error"
            self.progress = str(e)
            self.log.error("generate failed: %s\n%s", e, traceback.format_exc())
        finally:
            self.lock.release()


class Handler(BaseHTTPRequestHandler):
    """The REST endpoints over a :class:`WebApp` (``app``, bound by
    :meth:`WebApp.handler`)."""

    app: WebApp = None

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, body: bytes, content_type: str):
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *a):
        self.app.log.info("http " + fmt, *a)

    def do_GET(self):
        app = self.app
        if self.path in ("/", "/index.html"):
            self._bytes(INDEX_HTML.encode(), "text/html; charset=utf-8")
        elif self.path == "/api/status":
            self._json({"status": app.status, "progress": app.progress, "step": app.step,
                        "outputs": app.outputs, "has_session": app.last is not None})
        elif self.path.startswith("/api/log/tail"):
            try:
                with open(app.log_path) as f:
                    lines = f.readlines()[-50:]
            except FileNotFoundError:
                lines = []
            self._json({"lines": lines})
        elif self.path.startswith("/video/"):
            try:
                path = app.outputs[int(self.path.split("/")[-1])]
                with open(path, "rb") as f:
                    data = f.read()
            except (ValueError, IndexError, OSError):
                return self._json({"error": "not found"}, 404)
            self._bytes(data, "video/mp4" if path.endswith(".mp4")
                        else "application/octet-stream")
        else:
            self._json({"error": "unknown endpoint"}, 404)

    def do_POST(self):
        app = self.app
        n = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError:
            return self._json({"error": "bad json"}, 400)
        if self.path == "/api/load":
            if app.pipe is None:
                app.load_models()
            self._json({"status": app.status})
        elif self.path == "/api/generate_long":
            if app.pipe is None:
                return self._json({"error": "model not loaded: POST /api/load"}, 409)
            if not app.lock.acquire(blocking=False):
                return self._json({"error": "busy"}, 429)
            # before the reply: a poll right after "started" must not read the
            # previous request's status
            app.status = "generating"
            threading.Thread(target=app.generate, args=(req,), daemon=True).start()
            self._json({"status": "started"})
        elif self.path == "/api/refine_prompt":
            from ..utils.video import load_image

            img = None
            if req.get("image_b64"):
                img = load_image(io.BytesIO(base64.b64decode(req["image_b64"])))
            self._json({"prompt": app.refine_prompt(req.get("prompt", ""), img)})
        else:
            self._json({"error": "unknown endpoint"}, 404)


def build_argparser():
    from ..sample import TEACACHE_THRESHOLD

    p = argparse.ArgumentParser(description="yume_tpu_torch web server")
    p.add_argument("--config", default="ti2v-5B")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--output_dir", default="./outputs/web")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=704)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--preload", action="store_true")
    p.add_argument("--quant", default="none", choices=["none", "int8", "int4"],
                   help="not ported (ROADMAP queue 1, item 6)")
    p.add_argument("--memory_optimization", action="store_true",
                   help="keep umT5 and the VAE in host memory, each on the device "
                        "only for its phase")
    p.add_argument("--refiner_model", default=None,
                   help="not ported: the HF and remote refiners need model files or a "
                        "network; /api/refine_prompt runs the template refiner")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree; > 1 is not ported to the CLI "
                        "(ROADMAP queue 1, item 4)")
    p.add_argument("--sp_kind", default="ulysses", choices=["ulysses", "ring", "usp"])
    p.add_argument("--pp", type=int, default=0, help="not ported (ROADMAP queue 1, item 8)")
    p.add_argument("--w8a8", action="store_true",
                   help="int8 × int8 matmuls for the DiT blocks' projections")
    p.add_argument("--teacache", action="store_true",
                   help=f"block-residual caching between denoise steps, adaptive at "
                        f"a rel-L1 threshold of {TEACACHE_THRESHOLD} by default")
    p.add_argument("--teacache_interval", type=int, default=None,
                   help="with --teacache: a fixed interval instead, the full DiT every "
                        "N-th step (larger is faster and further from the uncached "
                        "result; see python -m yume_tpu_torch.sample --help)")
    p.add_argument("--teacache_threshold", type=float, default=None,
                   help=f"with --teacache: the adaptive threshold (default "
                        f"{TEACACHE_THRESHOLD}); not with --teacache_interval")
    p.add_argument("--device", default="cuda", help="device of the pipeline (cuda or cpu)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    app = WebApp(args)
    if args.preload:
        app.load_models()
    srv = ThreadingHTTPServer((args.host, args.port), app.handler())
    print(f"yume_tpu_torch webapp on http://{args.host}:{srv.server_address[1]} "
          f"(log: {app.log_path})")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        app.close()


if __name__ == "__main__":
    main()
