"""HTTP front end around ``Predictor`` (port of
din_tpu/experiments/serve_http.py): the Python standard library's
``http.server``, no other dependency, and din_tpu's protocol.

Protocol
  GET  /healthz   -> 200 {"ok": true, "model": ..., "pad_to": ...}
  POST /predict   -> body = .npz with arrays
                       images      uint8 [B,T,H,W,3]
                       boxes       f32   [B,T,N,4]  (feature-map coords)
                       bboxes_num  i32   [B,T]      (collective models)
                     response = JSON {"activities": [[...]], "actions"?: ...}
                     (softmax posteriors, batch-major lists)
  A body that is not such an .npz, or that the model cannot answer, gets a
  400 with {"error": ...}.

Run (on the card; ``--device cpu`` only when asked):
  python -m din_tpu_torch.experiments.serve_http \\
      --preset volleyball_stage2_dynamic \\
      --ckpt result/<exp>/stage2_epoch3_91.20%.pth --port 8787 --pad-to 2

Client (standard library only):
  buf = io.BytesIO(); np.savez(buf, images=images, boxes=boxes)
  urllib.request.urlopen("http://host:8787/predict", data=buf.getvalue())

The server holds one ``Predictor``: the model is built and its weights put
on the card once, at start.  Requests are answered one at a time (a lock
around the predictor), so two requests never share the card's memory.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Handler(BaseHTTPRequestHandler):
    predictor = None          # set on the server's handler class by
    info: dict = {}           # make_server
    lock = None

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):          # quiet by default
        pass

    def do_GET(self):
        if self.path == "/healthz":
            return self._send(200, {"ok": True, **self.info})
        return self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/predict":
            return self._send(404, {"error": f"unknown path {self.path}"})
        try:
            n = int(self.headers.get("Content-Length", "0"))
            arrs = np.load(io.BytesIO(self.rfile.read(n)),
                           allow_pickle=False)
            if "images" not in arrs or "boxes" not in arrs:
                raise ValueError("request .npz needs 'images' and 'boxes'")
            with self.lock:
                out = self.predictor(
                    arrs["images"], arrs["boxes"],
                    arrs["bboxes_num"] if "bboxes_num" in arrs else None)
        except Exception as e:  # noqa: BLE001 - a bad request, not a crash
            return self._send(400, {"error": f"{type(e).__name__}: {e}"})
        return self._send(200, {k: np.asarray(v).tolist()
                                for k, v in out.items()})


def make_server(predictor, host: str = "127.0.0.1", port: int = 0,
                info: dict | None = None) -> ThreadingHTTPServer:
    """Binds a threaded HTTP server around ``predictor`` (port 0: any free
    port; the bound one is ``server.server_address[1]``).  The caller runs
    ``server.serve_forever()`` (or a thread around it), then
    ``server.shutdown()`` and ``server.server_close()``."""
    handler = type("Handler", (_Handler,),
                   {"predictor": staticmethod(predictor),
                    "info": info or {}, "lock": threading.Lock()})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS

    p = argparse.ArgumentParser(description="din_tpu_torch HTTP serving")
    p.add_argument("--preset", default="volleyball_stage2_dynamic",
                   choices=sorted(PRESETS))
    p.add_argument("--ckpt", default=None,
                   help="stage-2 .pth (random weights if omitted)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--pad-to", type=int, default=4,
                   help="fixed serving batch: every call has this many clips")
    p.add_argument("--device", default=None,
                   help="default: the card (cuda); 'cpu' only when asked")
    args = p.parse_args(argv)

    cfg = PRESETS[args.preset]()
    predictor = Predictor.from_checkpoint(cfg, args.ckpt, pad_to=args.pad_to,
                                          device=args.device)
    srv = make_server(predictor, args.host, args.port,
                      info={"model": cfg.inference_module_name,
                            "pad_to": predictor.pad_to})
    print(f"serving {cfg.inference_module_name} on "
          f"http://{args.host}:{srv.server_address[1]} (pad_to="
          f"{predictor.pad_to}, {predictor.device})", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
