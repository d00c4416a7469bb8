"""Inference server.

Counterpart of vision_transformers_torch_xla_tpu/launch/serve.py: a stdlib
HTTP server around one forward pass, JPEG in (decoded by the native runtime
when it loads, else by PIL), top-k JSON out. Same endpoints, flags and
replies; `--ckpt` takes a `{'model': state_dict}` .pth (the JAX package's
ckpt/torch_export.py::save_torch_checkpoint writes one), or the trainer's
checkpoints directory (`<output_dir>/checkpoints`), read as JAX
launch/serve.py:63-76 reads one: the newest epoch, its EMA weights with
`--use_ema` when they were saved, else its params. Without a checkpoint
the weights come from a torch.Generator seeded 0.

    python -m vision_transformers_torch_xla_tpu_torch.launch.serve \
        --model my_vit_b --act_layer gelu_tanh --ckpt model.pth --port 8476
    python -m vision_transformers_torch_xla_tpu_torch.launch.serve \
        --model my_vit_b --act_layer gelu_tanh --use_ema \
        --ckpt run/checkpoints
    python -m vision_transformers_torch_xla_tpu_torch.launch.serve \
        --model vit_base_patch14_dinov2 --image_size 518 --global_pool token

The model is built without `use_pallas_attn`, as the JAX server builds
it (launch/serve.py:51-54): attention runs `reference_attention`, in plain
PyTorch ops and cuBLAS, and no attention kernel launches.

Endpoints:
    GET  /healthz            -> {"status": "ok", "model": ...}
    POST /predict            -> body: JPEG bytes; reply: {"topk": [[cls, p]..]}

`--device` defaults to cuda and raises when there is no card; the CPU is
used only when `--device cpu` is passed.
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from vision_transformers_torch_xla_tpu_torch.core.dtypes import get_policy
from vision_transformers_torch_xla_tpu_torch.models import create_model
from vision_transformers_torch_xla_tpu_torch.models.layers import init_weights

log = logging.getLogger(__name__)


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available; pass "
                           f"--device cpu to serve on the CPU")
    return dev


def read_weights(ckpt: str, use_ema: bool = False):
    """The state dict to serve: a checkpoints directory's newest epoch (its
    EMA weights with `use_ema` when they were saved, else its params), or
    a .pth's 'model' ('model_ema' with `use_ema`) entry."""
    if not os.path.isdir(ckpt):
        from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
            load_checkpoint,
        )

        return load_checkpoint(ckpt, "model_ema" if use_ema else "model")
    from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    raw = CheckpointManager(os.path.abspath(ckpt)).restore_raw()
    if raw is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt}")
    ema = raw.get("ema_params")
    return ema if (use_ema and ema is not None) else raw["params"]


class InferenceEngine:
    """Fixed-shape bf16 forward behind a lock."""

    def __init__(self, model_name: str, ckpt: str = "",
                 image_size: int = 224, num_classes: int = 1000,
                 use_ema: bool = False, device: str = "cuda",
                 global_pool: str = "avg", act_layer: str = ""):
        # global_pool/act_layer must mirror the trained model's config
        self.device = resolve_device(device)
        self.image_size = image_size
        self.model_name = model_name
        policy = get_policy("bf16")
        self.model = create_model(model_name, num_classes=num_classes,
                                  img_size=image_size,
                                  global_pool=global_pool or None,
                                  act_layer=act_layer or None,
                                  dtype=policy.compute_dtype,
                                  param_dtype=policy.param_dtype,
                                  device=self.device)
        if ckpt:
            self.model.load_state_dict(read_weights(ckpt, use_ema),
                                       strict=True)
        else:
            init_weights(self.model,
                         torch.Generator(device=self.device).manual_seed(0))
        self.model.eval()
        # warm the first call (cuBLAS plans, allocator)
        self._forward(np.zeros((1, image_size, image_size, 3), np.float32))
        self._lock = threading.Lock()

    @torch.inference_mode()
    def _forward(self, images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(images).to(self.device)
        probs = torch.softmax(self.model(x), dim=-1)
        return probs.cpu().numpy()

    def _decode(self, data: bytes) -> np.ndarray:
        from vision_transformers_torch_xla_tpu_torch.data import native
        from vision_transformers_torch_xla_tpu_torch.data.transforms import (
            IMAGENET_DEFAULT_MEAN,
            IMAGENET_DEFAULT_STD,
            central_crop_window,
        )

        s = self.image_size
        if native.available():
            w, h = native.jpeg_dims(data)
            return native.decode_jpeg_crop_resize(
                data, s, crop=central_crop_window(w, h, s))
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGB").resize((s, s))
        arr = np.asarray(img, np.float32) / 255.0
        return ((arr - np.asarray(IMAGENET_DEFAULT_MEAN, np.float32)) /
                np.asarray(IMAGENET_DEFAULT_STD, np.float32))

    def predict(self, data: bytes, topk: int = 5):
        img = self._decode(data)[None]
        with self._lock:
            probs = self._forward(img)[0]
        idx = np.argsort(probs)[::-1][:topk]
        return [[int(i), float(probs[i])] for i in idx]


def make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "model": engine.model_name,
                                  "image_size": engine.image_size})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                return self._reply(404, {"error": "unknown path"})
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                topk = engine.predict(data)
            except Exception as e:
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            self._reply(200, {"topk": topk})

    return Handler


def serve(engine: InferenceEngine, port: int = 8476,
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    log.info("serving %s on %s:%d", engine.model_name, host,
             server.server_address[1])
    return server


def main():
    ap = argparse.ArgumentParser("inference server")
    ap.add_argument("--model", default="my_vit_b")
    ap.add_argument("--ckpt", default="",
                    help="{'model': state_dict} .pth or the trainer's "
                         "checkpoints directory; '' = seeded init")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--nb_classes", type=int, default=1000)
    ap.add_argument("--use_ema", action="store_true",
                    help="serve the EMA weights ('model_ema' of a .pth)")
    ap.add_argument("--port", type=int, default=8476)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--global_pool", default="avg",
                    help="must mirror the trained model (trainer default)")
    ap.add_argument("--act_layer", default="",
                    help="'' = model default; recipe runs use gelu_tanh")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    engine = InferenceEngine(args.model, args.ckpt, args.image_size,
                             args.nb_classes, args.use_ema, args.device,
                             args.global_pool, args.act_layer)
    serve(engine, args.port).serve_forever()


if __name__ == "__main__":
    main()
