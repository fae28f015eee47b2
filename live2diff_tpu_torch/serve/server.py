"""The live streaming demo server of the PyTorch/CUDA port.

    python -m live2diff_tpu_torch.serve.server [--sessions N] [--device cuda|cpu]

A port of ``demo/server.py``, with the same protocol, classes and flags
(plus ``--device``), on stdlib asyncio with a minimal RFC6455 WebSocket
layer:

  WS   /api/ws/{user_id}        params JSON + JPEG frames in
  GET  /api/stream/{user_id}    multipart MJPEG out
  GET  /api/settings            pipeline input schema
  GET  /api/queue               queue size
  GET  /                        single-file frontend (camera -> WS -> MJPEG)

With ``--sessions 1`` one ``StreamV2VWrapper`` serves the users in turn
(``DemoPipeline``); with more, each user owns a slot of one ``MultiStream``
and a dispatcher steps every fed slot in one batched round
(``BatchedDemoPipeline``: the plain step when every slot has a frame, the
masked step otherwise). The first 8 frames of a session (or after a prompt
change) fill its warmup buffer, then it streams. MJPEG frames are encoded
by ``serve/framepump`` (libjpeg) where it builds, else by Pillow;
``jpeg_encoder_counts`` says which served. The pipelines run on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import hashlib
import io
import json
import logging
import os
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
log = logging.getLogger("live2diff-tpu-torch.demo")

WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# pydantic-model_json_schema-shaped payloads, matching the surface the
# reference frontend consumes (the original Live2Diff demo's app.py:126-146,
# vid2vid.py:45-80): settings -> {info.properties, input_params.properties,
# max_queue_size, page_content}.
INPUT_PARAMS_SCHEMA = {
    "properties": {
        "prompt": {
            "type": "string", "title": "Prompt", "field": "textarea",
            "id": "prompt", "default": "a person",
        },
        "seed": {
            "type": "integer", "title": "Seed", "field": "seed",
            "id": "seed", "default": 42, "hide": True,
        },
        "width": {
            "type": "integer", "title": "Width", "id": "width",
            "default": 512, "hide": True, "disabled": True,
        },
        "height": {
            "type": "integer", "title": "Height", "id": "height",
            "default": 512, "hide": True, "disabled": True,
        },
    }
}

INFO_SCHEMA = {
    "properties": {
        "name": {"default": "live2diff-tpu"},
        "input_mode": {"default": "image"},
    }
}

PAGE_CONTENT = (
    '<h1 class="title">live2diff-tpu</h1>'
    '<h2 class="subtitle">Live stream translation via uni-directional '
    "video diffusion &mdash; PyTorch/CUDA port</h2>"
)


class ServerFullException(Exception):
    pass


# the tiny random-weight model of --tiny (64x64 frames, fp32, no depth)
TINY_KWARGS = dict(
    unet_overrides=dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                        norm_num_groups=4, motion_num_attention_heads=2),
    dtype="float32", use_depth=False,
)


# ---------------------------------------------------------------------------
# pipeline wrapper with the demo warmup state machine
# ---------------------------------------------------------------------------


class DemoPipeline:
    WARMUP_FRAMES = 8

    def __init__(self, config_path: str, height: int, width: int,
                 synthetic: bool = False, tiny: bool = False, device: str = "cuda"):
        self.height, self.width = height, width
        self.synthetic = synthetic
        self.warmup_buffer = []
        self.current_prompt: Optional[str] = None
        self.stream = None
        self._lock = threading.Lock()
        if not synthetic:
            from ..wrapper import StreamV2VWrapper

            self.stream = StreamV2VWrapper(
                config_path, height=height, width=width, output_type="np", device=device,
                **(TINY_KWARGS if tiny else {}))

    def predict(self, params: dict, frame: np.ndarray) -> Optional[np.ndarray]:
        with self._lock:  # executor threads must not interleave on one stream
            prompt = params.get("prompt", "")
            if self.synthetic:  # loopback mode for serving-layer tests
                return 255 - frame
            if prompt != self.current_prompt:
                self.current_prompt = prompt
                self.warmup_buffer = []
            if len(self.warmup_buffer) < self.WARMUP_FRAMES:
                self.warmup_buffer.append(frame)
                if len(self.warmup_buffer) == self.WARMUP_FRAMES:
                    self.stream.prepare(prompt, np.stack(self.warmup_buffer))
                return None
            out = self.stream(frame)
            return out  # uint8 HWC


class BatchedDemoPipeline:
    """S concurrent users -> one batched step (one graph replay) a round.

    Each user owns a ``MultiStream`` slot and the dispatcher steps every
    warm slot in one batched round, so sessions share the weight reads
    (``stream/multi.py``). Users join and leave: admission warms a free
    slot through ``prepare_session``, disconnection frees it.

    ``predict_batch`` runs in the dispatcher's executor thread and
    ``release`` in the event loop's, so a lock keeps a user's slot from
    going while a round that holds it runs.
    """

    WARMUP_FRAMES = 8
    batched = True

    def __init__(self, config_path: str, height: int, width: int, sessions: int,
                 synthetic: bool = False, tiny: bool = False,
                 synthetic_latency: float = 0.0,
                 kv_cache_dtype: Optional[str] = None, device: str = "cuda"):
        self.height, self.width = height, width
        self.sessions = sessions
        self.synthetic = synthetic
        self.synthetic_latency = synthetic_latency
        self._slots: Dict[str, int] = {}
        self._free = list(range(sessions))
        self._warm: Dict[str, list] = {}
        self._prompt: Dict[str, str] = {}
        self._states = None
        self._lock = threading.Lock()
        self.multi = None
        if not synthetic:
            from ..stream.multi import MultiStream
            from ..wrapper import StreamV2VWrapper

            kwargs = dict(TINY_KWARGS) if tiny else {}
            if kv_cache_dtype:
                kwargs["kv_cache_dtype"] = kv_cache_dtype
            self.wrapper = StreamV2VWrapper(
                config_path, height=height, width=width, output_type="np", device=device,
                **kwargs)
            # both steps are captured here, before any user is admitted
            self.multi = MultiStream(self.wrapper.stream, sessions)

    def release(self, user_id: str) -> None:
        with self._lock:
            slot = self._slots.pop(user_id, None)
            self._warm.pop(user_id, None)
            self._prompt.pop(user_id, None)
            if slot is not None:
                self._free.append(slot)

    def predict_batch(self, batch: Dict[str, tuple]) -> Dict[str, Optional[np.ndarray]]:
        """{uid: (params, frame)} -> {uid: output frame or None (warming)}."""
        with self._lock:
            return self._predict_batch(batch)

    def _predict_batch(self, batch: Dict[str, tuple]) -> Dict[str, Optional[np.ndarray]]:
        if self.synthetic:
            if self.synthetic_latency:
                time.sleep(self.synthetic_latency)  # one model call per ROUND
            return {uid: 255 - frame for uid, (_, frame) in batch.items()}

        outs: Dict[str, Optional[np.ndarray]] = {uid: None for uid in batch}
        fresh: Dict[str, np.ndarray] = {}
        for uid, (params, frame) in batch.items():
            slot = self._slots.get(uid)
            if slot is None:
                if not self._free:
                    continue  # admission should have 503'd already
                slot = self._free.pop(0)
                self._slots[uid] = slot
            prompt = params.get("prompt", "")
            if prompt != self._prompt.get(uid):
                self._prompt[uid] = prompt
                self._warm[uid] = []
            buf = self._warm.setdefault(uid, [])
            if len(buf) < self.WARMUP_FRAMES:
                buf.append(frame)
                if len(buf) == self.WARMUP_FRAMES:
                    embeds = self.wrapper.encode_prompt(prompt)
                    self._states, _ = self.multi.prepare_session(
                        self._states, slot, np.stack(buf), embeds,
                        seed=self.wrapper.seed,
                    )
                continue
            fresh[uid] = frame

        if not fresh or self._states is None:
            return outs
        # Idle-but-warm slots are masked out of the state update (active
        # mask): no frame, no step, as on the single-user path. They still
        # run in the batch (its shape is fixed), and their state is restored
        # inside the step.
        frames = np.zeros((self.sessions, self.height, self.width, 3), np.uint8)
        active = np.zeros((self.sessions,), bool)
        for uid, f in fresh.items():
            frames[self._slots[uid]] = f
            active[self._slots[uid]] = True
        # full-load rounds (every slot fed) take the plain step: no masking
        # cost exactly when aggregate throughput matters
        self._states, out = self.multi(
            self._states, frames, None if active.all() else active)
        out = out.cpu().numpy()
        for uid in fresh:
            outs[uid] = out[self._slots[uid]]
        return outs


# ---------------------------------------------------------------------------
# connection manager (per-user frame queues)
# ---------------------------------------------------------------------------


class ConnectionManager:
    def __init__(self, max_queue_size: int = 4, max_users: int = 4):
        self.queues: Dict[str, asyncio.Queue] = {}
        self.max_queue_size = max_queue_size
        self.max_users = max_users

    def connect(self, user_id: str) -> asyncio.Queue:
        if len(self.queues) >= self.max_users and user_id not in self.queues:
            raise ServerFullException("server at capacity")
        q = asyncio.Queue(maxsize=self.max_queue_size)
        self.queues[user_id] = q
        return q

    def disconnect(self, user_id: str) -> None:
        self.queues.pop(user_id, None)

    async def put(self, user_id: str, item) -> None:
        q = self.queues.get(user_id)
        if q is None:
            return
        if q.full():  # drop oldest to stay real-time
            try:
                q.get_nowait()
            except asyncio.QueueEmpty:
                pass
        await q.put(item)

    def queue_size(self) -> int:
        return len(self.queues)


# ---------------------------------------------------------------------------
# minimal HTTP + WebSocket handling
# ---------------------------------------------------------------------------


async def read_http_request(reader: asyncio.StreamReader):
    request_line = await reader.readline()
    if not request_line:
        return None
    parts = request_line.decode("latin1").strip().split()
    if len(parts) < 3:
        return None
    method, path = parts[0], parts[1]
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin1").partition(":")
        headers[k.strip().lower()] = v.strip()
    body = b""
    if "content-length" in headers:
        body = await reader.readexactly(int(headers["content-length"]))
    return method, path, headers, body


def http_response(status: str, body: bytes, content_type: str = "application/json",
                  extra: str = "") -> bytes:
    return (
        f"HTTP/1.1 {status}\r\nContent-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\nAccess-Control-Allow-Origin: *\r\n"
        f"{extra}Connection: close\r\n\r\n"
    ).encode() + body


async def ws_handshake(writer: asyncio.StreamWriter, headers: dict) -> bool:
    key = headers.get("sec-websocket-key")
    if not key:
        return False
    accept = base64.b64encode(
        hashlib.sha1((key + WS_MAGIC).encode()).digest()
    ).decode()
    writer.write(
        (
            "HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Accept: {accept}\r\n\r\n"
        ).encode()
    )
    await writer.drain()
    return True


async def ws_recv(reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter = None):
    """-> (opcode, complete message payload) or None on close.

    RFC6455-complete receive: continuation frames (FIN=0 + opcode 0x0) are
    reassembled into one message, interleaved pings are answered inline
    (control frames may arrive BETWEEN fragments, so the pong cannot be
    left to the caller without losing the fragment buffer), pongs are
    swallowed.
    """
    msg_opcode = None
    buf = bytearray()
    while True:
        hdr = await reader.readexactly(2)
        fin_op, mask_len = hdr
        fin = fin_op & 0x80
        opcode = fin_op & 0x0F
        masked = mask_len & 0x80
        length = mask_len & 0x7F
        if length == 126:
            length = struct.unpack(">H", await reader.readexactly(2))[0]
        elif length == 127:
            length = struct.unpack(">Q", await reader.readexactly(8))[0]
        mask = await reader.readexactly(4) if masked else b"\x00" * 4
        payload = bytearray(await reader.readexactly(length))
        if masked:
            for i in range(length):
                payload[i] ^= mask[i % 4]
        if opcode == 0x8:  # close
            return None
        if opcode == 0x9:  # ping: echo payload as pong
            if writer is not None:
                writer.write(ws_frame(bytes(payload), 0xA))
                await writer.drain()
            continue
        if opcode == 0xA:  # pong: ignore
            continue
        if opcode:  # first (or only) fragment of a data message
            msg_opcode = opcode
            buf = payload
        else:  # continuation
            buf.extend(payload)
        if fin:
            return msg_opcode, bytes(buf)


def ws_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < (1 << 16):
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    return header + payload


async def ws_send_json(writer: asyncio.StreamWriter, obj) -> None:
    writer.write(ws_frame(json.dumps(obj).encode(), 0x1))
    await writer.drain()


# ---------------------------------------------------------------------------
# image codecs (libjpeg through framepump, else Pillow)
# ---------------------------------------------------------------------------

# MJPEG frames encoded by each route
jpeg_encoder_counts = {"libjpeg": 0, "pillow": 0}


def jpeg_to_array(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def array_to_jpeg(arr: np.ndarray, quality: int = 80) -> bytes:
    from . import framepump

    encoded = framepump.encode_jpeg(np.ascontiguousarray(arr), quality)
    if encoded is not None:
        jpeg_encoder_counts["libjpeg"] += 1
        return encoded
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    jpeg_encoder_counts["pillow"] += 1
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


class App:
    def __init__(self, pipeline: DemoPipeline, max_queue_size: int = 4,
                 max_users: int = 4, timeout: float = 0.0, debug: bool = False):
        self.pipeline = pipeline
        self.manager = ConnectionManager(max_queue_size=max_queue_size,
                                         max_users=max_users)
        self.outputs: Dict[str, asyncio.Queue] = {}
        self.timeout = timeout
        self.debug = debug
        # batched mode: frames land in `pending` (newest-wins per user) and
        # one dispatcher task drains them through predict_batch
        self.batched = getattr(pipeline, "batched", False)
        self.pending: Dict[str, tuple] = {}
        self._pending_event = asyncio.Event()
        self._dispatcher: Optional[asyncio.Task] = None

    def _ensure_dispatcher(self) -> None:
        if self.batched and (self._dispatcher is None or self._dispatcher.done()):
            self._dispatcher = asyncio.get_running_loop().create_task(
                self.dispatch_loop()
            )

    async def dispatch_loop(self) -> None:
        """One batched model call per round; fan outputs back per user."""
        loop = asyncio.get_running_loop()
        while True:
            await self._pending_event.wait()
            batch, self.pending = self.pending, {}
            self._pending_event.clear()
            t0 = time.perf_counter()
            outs = await loop.run_in_executor(
                None, self.pipeline.predict_batch, batch
            )
            if self.debug:
                log.info("batch of %d: %.1f ms", len(batch),
                         (time.perf_counter() - t0) * 1000)
            for uid, out in outs.items():
                if out is None:
                    continue
                oq = self.outputs.get(uid)
                if oq is None:
                    continue
                if oq.full():
                    try:
                        oq.get_nowait()
                    except asyncio.QueueEmpty:
                        pass
                await oq.put(out)

    async def handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            req = await read_http_request(reader)
            if req is None:
                return
            method, path, headers, body = req

            if path.startswith("/api/ws/"):
                await self.handle_ws(path.split("/")[-1], reader, writer, headers)
                return
            if path.startswith("/api/stream/"):
                await self.handle_mjpeg(path.split("/")[-1], writer)
                return
            if path == "/api/settings":
                schema = json.loads(json.dumps(INPUT_PARAMS_SCHEMA))
                for key in ("width", "height"):
                    schema["properties"][key]["default"] = getattr(
                        self.pipeline, key, schema["properties"][key]["default"]
                    )
                writer.write(http_response(
                    "200 OK", json.dumps({
                        "info": INFO_SCHEMA,
                        "input_params": schema,
                        "max_queue_size": self.manager.max_users,
                        "page_content": PAGE_CONTENT,
                    }).encode()))
            elif path == "/api/queue":
                writer.write(http_response(
                    "200 OK", json.dumps({"queue_size": self.manager.queue_size()}).encode()))
            elif path == "/" or path == "/index.html":
                writer.write(http_response("200 OK", load_frontend(), "text/html"))
            elif path.startswith("/static/"):
                writer.write(serve_static(path[len("/static/"):]))
            else:
                writer.write(http_response("404 Not Found", b'{"error":"not found"}'))
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except ServerFullException:
            writer.write(http_response("503 Service Unavailable", b'{"error":"full"}'))
            await writer.drain()
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def handle_ws(self, user_id: str, reader, writer, headers):
        queue = self.manager.connect(user_id)
        self._ensure_dispatcher()
        self.outputs.setdefault(user_id, asyncio.Queue(maxsize=2))
        if not await ws_handshake(writer, headers):
            self.manager.disconnect(user_id)
            return
        log.info("ws connect user=%s", user_id)
        await ws_send_json(writer, {"status": "connected", "userId": user_id})
        await ws_send_json(writer, {"status": "send_frame"})
        params: dict = {}
        last_seen = time.time()
        try:
            while True:
                msg = await ws_recv(reader, writer)  # pings answered inline
                if msg is None:
                    break
                opcode, payload = msg
                if self.timeout and time.time() - last_seen > self.timeout:
                    await ws_send_json(writer, {"status": "timeout"})
                    break
                last_seen = time.time()
                if opcode == 0x1:  # text: params or control
                    data = json.loads(payload or b"{}")
                    if data.get("status") == "next_frame":
                        await ws_send_json(writer, {"status": "send_frame"})
                    else:
                        params.update(data)
                    continue
                if opcode == 0x2:  # binary: JPEG frame
                    frame = jpeg_to_array(payload)
                    if self.batched:
                        self.pending[user_id] = (dict(params), frame)
                        self._pending_event.set()
                    else:
                        await self.manager.put(user_id, (dict(params), frame))
                        await self.process_one(user_id)
                    await ws_send_json(writer, {"status": "send_frame"})
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            log.info("ws disconnect user=%s", user_id)
            self.manager.disconnect(user_id)
            self.pending.pop(user_id, None)
            if self.batched:
                self.pipeline.release(user_id)

    async def process_one(self, user_id: str) -> None:
        q = self.manager.queues.get(user_id)
        if q is None or q.empty():
            return
        params, frame = await q.get()
        t0 = time.perf_counter()
        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(None, self.pipeline.predict, params, frame)
        if self.debug:
            log.info("predict %.1f ms", (time.perf_counter() - t0) * 1000)
        if out is None:
            return
        oq = self.outputs[user_id]
        if oq.full():
            try:
                oq.get_nowait()
            except asyncio.QueueEmpty:
                pass
        await oq.put(out)

    async def handle_mjpeg(self, user_id: str, writer: asyncio.StreamWriter):
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: multipart/x-mixed-replace; boundary=frame\r\n"
            b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n"
        )
        await writer.drain()
        oq = self.outputs.setdefault(user_id, asyncio.Queue(maxsize=2))
        try:
            while True:
                out = await oq.get()
                jpg = array_to_jpeg(out)
                writer.write(
                    b"--frame\r\nContent-Type: image/jpeg\r\n"
                    + f"Content-Length: {len(jpg)}\r\n\r\n".encode() + jpg + b"\r\n"
                )
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass


_STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")


_MIME = {
    ".html": "text/html", ".css": "text/css",
    ".js": "text/javascript", ".mjs": "text/javascript",
    ".json": "application/json", ".svg": "image/svg+xml",
    ".png": "image/png", ".ico": "image/x-icon",
}


def load_frontend() -> bytes:
    """App shell (static/index.html); modules load via /static/."""
    path = os.path.join(_STATIC_DIR, "index.html")
    with open(path, "rb") as f:
        return f.read()


def serve_static(rel: str) -> bytes:
    """Serve a frontend asset under static/, refusing path escapes."""
    base = os.path.realpath(_STATIC_DIR)
    full = os.path.realpath(os.path.join(base, rel))
    if not full.startswith(base + os.sep) or not os.path.isfile(full):
        return http_response("404 Not Found", b'{"error":"not found"}')
    ctype = _MIME.get(os.path.splitext(full)[1], "application/octet-stream")
    with open(full, "rb") as f:
        return http_response("200 OK", f.read(), ctype)


def make_pipeline(args):
    """The pipeline the flags ask for: batched with ``--sessions`` > 1."""
    if args.sessions > 1:
        return BatchedDemoPipeline(
            args.config, args.height, args.width, args.sessions,
            synthetic=args.synthetic, tiny=args.tiny,
            synthetic_latency=args.synthetic_latency,
            kv_cache_dtype=args.kv_cache, device=args.device,
        )
    return DemoPipeline(args.config, args.height, args.width,
                        synthetic=args.synthetic, tiny=args.tiny, device=args.device)


async def amain(args) -> None:
    pipeline = make_pipeline(args)
    app = App(pipeline, max_queue_size=args.max_queue_size,
              max_users=args.sessions if args.sessions > 1 else 4,
              timeout=args.timeout, debug=args.debug)
    server = await asyncio.start_server(app.handle, args.host, args.port)
    log.info("serving on http://%s:%d", args.host, args.port)
    async with server:
        await server.serve_forever()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/disneyPixar.yaml")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--max-queue-size", type=int, default=4)
    p.add_argument("--sessions", type=int, default=1,
                   help=">1 serves users through one batched MultiStream")
    p.add_argument("--kv-cache", choices=["bf16", "int8"], default=None)
    p.add_argument("--synthetic-latency", type=float, default=0.0,
                   help="per-ROUND model latency in synthetic batched mode")
    p.add_argument("--timeout", type=float, default=0.0)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="loopback pipeline (serving-layer test mode)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight model at 64x64")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the kernels' plain versions run")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    if args.tiny:
        args.height = args.width = 64
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
