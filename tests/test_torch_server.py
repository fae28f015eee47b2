"""The port's demo server (``live2diff_tpu_torch.serve.server``): the cases
of tests/test_demo_server.py against the port's ``App`` with the synthetic
pipelines, driven through real sockets (WebSocket handshake and framing,
the per-user queues, the MJPEG stream), plus ``BatchedDemoPipeline`` over
the tiny port pipeline on the CPU with two users, held to single streams
of the same seed.
"""

import asyncio
import base64
import io
import json
import os
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest
from PIL import Image

from live2diff_tpu_torch.serve import server as server_module
from live2diff_tpu_torch.serve.server import App, BatchedDemoPipeline, DemoPipeline


def _start_server(app, port):
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        srv = await asyncio.start_server(app.handle, "127.0.0.1", port)
        started.set()
        async with srv:
            await srv.serve_forever()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()), daemon=True)
    t.start()
    assert started.wait(5)


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _http_get(port, path):
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    buf = b""
    while True:
        chunk = c.recv(65536)
        if not chunk:
            break
        buf += chunk
    c.close()
    head, _, body = buf.partition(b"\r\n\r\n")
    return head, body


@pytest.fixture()
def server_port():
    with socket.socket() as probe:  # grab a free ephemeral port
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    pipeline = DemoPipeline("unused", 64, 64, synthetic=True)
    app = App(pipeline)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        srv = await asyncio.start_server(app.handle, "127.0.0.1", port)
        started.set()
        async with srv:
            await srv.serve_forever()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()), daemon=True)
    t.start()
    assert started.wait(5)
    yield port
    # daemon thread + per-test port: let the loop die with the process
    # (stopping it mid-serve_forever raises noisy teardown errors)


class _WSClient:
    """Buffered client: WS frames may arrive coalesced with the 101 response."""

    def __init__(self, port, uid):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        self.buf = b""
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            (f"GET /api/ws/{uid} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
             f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n\r\n").encode()
        )
        while b"\r\n\r\n" not in self.buf:
            self.buf += self.sock.recv(4096)
        head, _, self.buf = self.buf.partition(b"\r\n\r\n")
        assert b"101" in head.split(b"\r\n")[0]

    def _read(self, n):
        while len(self.buf) < n:
            self.buf += self.sock.recv(4096)
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send_raw(self, payload, opcode, fin=True):
        mask = os.urandom(4)
        header = bytes([(0x80 if fin else 0x00) | opcode])
        n = len(payload)
        if n < 126:
            header += bytes([0x80 | n])
        elif n < (1 << 16):
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        self.sock.sendall(
            header + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        )

    def send(self, payload, opcode):
        self.send_raw(payload, opcode, fin=True)

    def send_fragmented(self, payload, opcode, n_fragments=3):
        """RFC6455 fragmentation: opcode + FIN=0, then 0x0 continuations."""
        chunk = max(1, len(payload) // n_fragments)
        parts = [payload[i:i + chunk] for i in range(0, len(payload), chunk)]
        for i, part in enumerate(parts):
            self.send_raw(part, opcode if i == 0 else 0x0,
                          fin=(i == len(parts) - 1))

    def recv(self):
        hdr = self._read(2)
        op, ln = hdr[0] & 0xF, hdr[1] & 0x7F
        if ln == 126:
            ln = struct.unpack(">H", self._read(2))[0]
        return op, self._read(ln)

    def close(self):
        self.sock.close()


def test_ws_mjpeg_roundtrip(server_port):
    port = server_port
    uid = "u1"
    frames_out = []

    def read_mjpeg():
        c = socket.create_connection(("127.0.0.1", port), timeout=10)
        c.sendall(f"GET /api/stream/{uid} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        buf = b""
        deadline = time.time() + 10
        while len(frames_out) < 2 and time.time() < deadline:
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
            while True:
                a, b = buf.find(b"\xff\xd8"), buf.find(b"\xff\xd9")
                if a == -1 or b == -1:
                    break
                frames_out.append(buf[a:b + 2])
                buf = buf[b + 2:]
        c.close()

    t = threading.Thread(target=read_mjpeg, daemon=True)
    t.start()

    s = _WSClient(port, uid)
    op, data = s.recv()
    assert json.loads(data)["status"] == "connected"

    img = np.zeros((32, 32, 3), np.uint8)
    img[:, :, 1] = 180
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    jpeg = buf.getvalue()

    sent = 0
    deadline = time.time() + 10
    while sent < 3 and time.time() < deadline:
        op, data = s.recv()
        if json.loads(data).get("status") == "send_frame":
            s.send(json.dumps({"prompt": "x"}).encode(), 0x1)
            s.send(jpeg, 0x2)
            sent += 1
    t.join(timeout=10)
    s.close()

    assert sent == 3
    assert len(frames_out) >= 2
    out = np.asarray(Image.open(io.BytesIO(frames_out[0])))
    # synthetic pipeline inverts: green 180 -> ~75
    assert out[:, :, 1].mean() < 100


def test_settings_schema_and_frontend(server_port):
    """Settings payload must carry the reference frontend's contract:
    input_params.properties with field metadata, info.properties,
    max_queue_size, page_content (/root/reference/demo/app.py:126-146)."""
    head, body = _http_get(server_port, "/api/settings")
    assert b"200" in head.split(b"\r\n")[0]
    settings = json.loads(body)
    props = settings["input_params"]["properties"]
    assert props["prompt"]["field"] == "textarea"
    assert props["prompt"]["id"] == "prompt"
    assert props["width"]["hide"] is True
    assert settings["info"]["properties"]["input_mode"]["default"] == "image"
    assert settings["max_queue_size"] >= 1
    assert "live2diff" in settings["page_content"]

    head, body = _http_get(server_port, "/")
    assert b"200" in head.split(b"\r\n")[0]
    page = body.decode()
    # app shell loads the module app (ref frontend structure: lib/ + components/)
    assert '/static/app.js' in page
    assert '/static/style.css' in page

    # walk the ES-module graph: every module the app imports must be served
    # with a JS content-type and itself resolve its own imports
    seen, queue = set(), ["app.js"]
    sources = {}
    while queue:
        rel = queue.pop()
        if rel in seen:
            continue
        seen.add(rel)
        head, body = _http_get(server_port, f"/static/{rel}")
        assert b"200" in head.split(b"\r\n")[0], rel
        assert b"text/javascript" in head, rel
        src = body.decode()
        sources[rel] = src
        base = rel.rsplit("/", 1)[0] + "/" if "/" in rel else ""
        for m in re.findall(r"from '([^']+)'", src):
            # resolve ./ and ../ relative to the importing module
            out = []
            for p in (base + m).split("/"):
                if p == "..":
                    out.pop()
                elif p not in (".", ""):
                    out.append(p)
            queue.append("/".join(out))
    # the full reference-frontend surface, now split across modules
    assert {"lib/store.js", "lib/lcmLive.js", "lib/mediaStream.js",
            "components/pipelineOptions.js", "components/imagePlayer.js",
            "components/videoInput.js"} <= seen
    allsrc = "".join(sources.values())
    for needle in ("/api/settings", "getDisplayMedia", "getUserMedia",
                   "/api/queue", "next_frame", "enumerateDevices"):
        assert needle in allsrc, needle

    # path traversal out of static/ must 404
    head, _ = _http_get(server_port, "/static/../server.py")
    assert b"404" in head.split(b"\r\n")[0]
    head, _ = _http_get(server_port, "/static/nope.js")
    assert b"404" in head.split(b"\r\n")[0]


def _pump_user(port, uid, duration, counts):
    """WS frame pump + MJPEG reader for one user; counts[uid] = outputs."""
    counts[uid] = 0

    def read_mjpeg():
        c = socket.create_connection(("127.0.0.1", port), timeout=10)
        c.sendall(f"GET /api/stream/{uid} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        c.settimeout(0.5)
        deadline = time.time() + duration + 1.0
        buf = b""
        while time.time() < deadline:
            try:
                chunk = c.recv(65536)
            except socket.timeout:
                continue
            if not chunk:
                break
            buf += chunk
            while True:
                a, b = buf.find(b"\xff\xd8"), buf.find(b"\xff\xd9")
                if a == -1 or b == -1:
                    break
                counts[uid] += 1
                buf = buf[b + 2:]
        c.close()

    reader = threading.Thread(target=read_mjpeg, daemon=True)
    reader.start()

    img = np.full((32, 32, 3), 128, np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    jpeg = buf.getvalue()

    s = _WSClient(port, uid)
    deadline = time.time() + duration
    while time.time() < deadline:
        op, data = s.recv()
        if json.loads(data).get("status") == "send_frame":
            s.send(json.dumps({"prompt": "x"}).encode(), 0x1)
            s.send(jpeg, 0x2)
    s.close()
    reader.join(timeout=3)


def _make_jpeg(h=32, w=32, value=180, quality=80):
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :, 1] = value
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _collect_mjpeg(port, uid, want, out_list, duration=10):
    c = socket.create_connection(("127.0.0.1", port), timeout=duration)
    c.sendall(f"GET /api/stream/{uid} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    c.settimeout(0.5)
    buf = b""
    deadline = time.time() + duration
    while len(out_list) < want and time.time() < deadline:
        try:
            chunk = c.recv(65536)
        except socket.timeout:
            continue
        if not chunk:
            break
        buf += chunk
        while True:
            a, b = buf.find(b"\xff\xd8"), buf.find(b"\xff\xd9")
            if a == -1 or b == -1:
                break
            out_list.append(buf[a:b + 2])
            buf = buf[b + 2:]
    c.close()


def test_ws_fragmented_frames(server_port):
    """RFC6455 continuation frames: a params JSON split over 3 fragments and
    a JPEG split over 4 must reassemble into whole messages."""
    port = server_port
    uid = "frag"
    frames_out = []
    t = threading.Thread(target=_collect_mjpeg, args=(port, uid, 1, frames_out),
                         daemon=True)
    t.start()

    s = _WSClient(port, uid)
    op, data = s.recv()
    assert json.loads(data)["status"] == "connected"
    jpeg = _make_jpeg()

    sent = 0
    deadline = time.time() + 10
    while sent < 2 and time.time() < deadline:
        op, data = s.recv()
        if json.loads(data).get("status") == "send_frame":
            s.send_fragmented(json.dumps({"prompt": "frag"}).encode(), 0x1, 3)
            s.send_fragmented(jpeg, 0x2, 4)
            sent += 1
    t.join(timeout=10)
    s.close()
    assert sent == 2
    assert len(frames_out) >= 1
    out = np.asarray(Image.open(io.BytesIO(frames_out[0])))
    assert out[:, :, 1].mean() < 100  # synthetic inverts green 180 -> ~75


def test_ws_ping_pong_and_interleaved_ping(server_port):
    """A ping must be answered with a pong echoing the payload — including a
    ping arriving BETWEEN fragments of a data message."""
    s = _WSClient(server_port, "pinger")
    op, data = s.recv()
    assert json.loads(data)["status"] == "connected"
    op, data = s.recv()
    assert json.loads(data)["status"] == "send_frame"

    s.send_raw(b"hello-ws", 0x9)
    op, data = s.recv()
    assert op == 0xA and data == b"hello-ws"

    # ping interleaved inside a fragmented text message
    payload = json.dumps({"prompt": "interleaved"}).encode()
    s.send_raw(payload[:4], 0x1, fin=False)
    s.send_raw(b"mid", 0x9)
    s.send_raw(payload[4:], 0x0, fin=True)
    op, data = s.recv()
    assert op == 0xA and data == b"mid"
    # connection still alive: next_frame control round-trips
    s.send(json.dumps({"status": "next_frame"}).encode(), 0x1)
    op, data = s.recv()
    assert json.loads(data)["status"] == "send_frame"
    s.close()


def test_ws_large_frame_64bit_length(server_port):
    """Binary frames >65535 bytes take the 8-byte extended-length path."""
    port = server_port
    uid = "big"
    frames_out = []
    t = threading.Thread(target=_collect_mjpeg, args=(port, uid, 1, frames_out),
                         daemon=True)
    t.start()

    rs = np.random.RandomState(0)
    noisy = rs.randint(0, 255, (256, 256, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(noisy).save(buf, format="JPEG", quality=100)
    jpeg = buf.getvalue()
    assert len(jpeg) > 65535, "test needs a >64KiB payload"

    s = _WSClient(port, uid)
    deadline = time.time() + 10
    sent = 0
    while sent < 1 and time.time() < deadline:
        op, data = s.recv()
        if json.loads(data).get("status") == "send_frame":
            s.send(json.dumps({"prompt": "big"}).encode(), 0x1)
            s.send(jpeg, 0x2)
            sent += 1
    t.join(timeout=10)
    s.close()
    assert len(frames_out) >= 1
    out = np.asarray(Image.open(io.BytesIO(frames_out[0])))
    assert out.shape[:2] == (256, 256)


def test_ws_mid_stream_disconnect_then_reconnect(server_port):
    """An abrupt socket drop mid-stream must free the slot; the same user id
    reconnects and streams again."""
    port = server_port
    uid = "dropper"
    jpeg = _make_jpeg()

    s = _WSClient(port, uid)
    deadline = time.time() + 10
    sent = 0
    while sent < 1 and time.time() < deadline:
        op, data = s.recv()
        if json.loads(data).get("status") == "send_frame":
            s.send(json.dumps({"prompt": "x"}).encode(), 0x1)
            s.send(jpeg, 0x2)
            sent += 1
    s.sock.close()  # abrupt: no close frame

    # server cleans up; reconnect with the same uid and stream again
    deadline = time.time() + 5
    while time.time() < deadline:
        head, body = _http_get(port, "/api/queue")
        if json.loads(body)["queue_size"] == 0:
            break
        time.sleep(0.1)
    assert json.loads(body)["queue_size"] == 0

    frames_out = []
    t = threading.Thread(target=_collect_mjpeg, args=(port, uid, 1, frames_out),
                         daemon=True)
    t.start()
    s2 = _WSClient(port, uid)
    sent = 0
    deadline = time.time() + 10
    while sent < 2 and time.time() < deadline:
        op, data = s2.recv()
        if json.loads(data).get("status") == "send_frame":
            s2.send(json.dumps({"prompt": "x"}).encode(), 0x1)
            s2.send(jpeg, 0x2)
            sent += 1
    t.join(timeout=10)
    s2.close()
    assert len(frames_out) >= 1


def test_prompt_change_resets_warmup_and_uses_template():
    """Mid-stream prompt change must reset the warmup accumulator and route
    the new prompt through wrapper.prepare (which template-expands it) —
    the reference demo's behaviour (demo/vid2vid.py:120-144)."""
    calls = []

    class _MockWrapper:
        batch_size = 2

        def prepare(self, prompt, frames, **kw):
            calls.append(("prepare", prompt, len(frames)))

        def __call__(self, frame):
            calls.append(("step",))
            return 255 - frame

    pipe = DemoPipeline.__new__(DemoPipeline)
    pipe.synthetic = False
    pipe.warmup_buffer = []
    pipe.current_prompt = None
    pipe.stream = _MockWrapper()
    import threading

    pipe._lock = threading.Lock()

    frame = np.full((8, 8, 3), 7, np.uint8)
    for i in range(8):
        assert pipe.predict({"prompt": "cat"}, frame) is None
    assert calls == [("prepare", "cat", 8)]
    assert pipe.predict({"prompt": "cat"}, frame) is not None

    # prompt change: warmup restarts; nothing streams until 8 new frames
    calls.clear()
    for i in range(8):
        assert pipe.predict({"prompt": "dog"}, frame) is None
    assert calls == [("prepare", "dog", 8)]
    assert pipe.predict({"prompt": "dog"}, frame) is not None


class _WarmupFakePipeline:
    """predict() returns None for each user's first 8 frames (warming), then
    echoes inverted frames — the DemoPipeline warmup contract without jax."""

    WARMUP_FRAMES = 8

    def __init__(self):
        self.seen = {}

    def predict(self, params, frame):
        uid_key = params.get("prompt", "")  # prompt doubles as user marker here
        n = self.seen.get(uid_key, 0) + 1
        self.seen[uid_key] = n
        if n <= self.WARMUP_FRAMES:
            return None
        return 255 - frame


def test_two_users_one_warming_one_streaming():
    """A user mid-warmup (predict -> None) must not stall another user who
    is already streaming outputs."""
    port = _free_port()
    app = App(_WarmupFakePipeline(), max_users=4)
    _start_server(app, port)
    jpeg = _make_jpeg()

    def pump(uid, n_frames, outputs):
        t = threading.Thread(target=_collect_mjpeg,
                             args=(port, uid, n_frames, outputs), daemon=True)
        t.start()
        s = _WSClient(port, uid)
        sent = 0
        deadline = time.time() + 15
        while sent < n_frames + 8 and time.time() < deadline:
            op, data = s.recv()
            if json.loads(data).get("status") == "send_frame":
                s.send(json.dumps({"prompt": uid}).encode(), 0x1)
                s.send(jpeg, 0x2)
                sent += 1
        s.close()
        return t

    out_a, out_b = [], []
    # user A fully warms (8 frames) then streams
    ta = pump("userA", 4, out_a)
    ta.join(timeout=15)
    assert len(out_a) >= 1, "warmed user got no outputs"

    # user B starts warming while A streams more
    tb_sock = _WSClient(port, "userB")
    for _ in range(3):  # B stays in warmup (3 < 8)
        op, data = tb_sock.recv()
        if json.loads(data).get("status") == "send_frame":
            tb_sock.send(json.dumps({"prompt": "userB"}).encode(), 0x1)
            tb_sock.send(jpeg, 0x2)
    out_a2 = []
    ta2 = pump("userA", 2, out_a2)
    ta2.join(timeout=15)
    tb_sock.close()
    assert len(out_a2) >= 1, "warming user B stalled streaming user A"
    assert len(out_b) == 0  # B never finished warmup


def test_concurrent_mjpeg_readers_same_user(server_port):
    """Two MJPEG consumers on one user id must both receive frames without
    wedging the server (frames are split between them)."""
    port = server_port
    uid = "dual"
    out1, out2 = [], []
    t1 = threading.Thread(target=_collect_mjpeg, args=(port, uid, 2, out1),
                          daemon=True)
    t2 = threading.Thread(target=_collect_mjpeg, args=(port, uid, 2, out2),
                          daemon=True)
    t1.start(), t2.start()

    s = _WSClient(port, uid)
    jpeg = _make_jpeg()
    sent = 0
    deadline = time.time() + 12
    while sent < 10 and time.time() < deadline:
        op, data = s.recv()
        if json.loads(data).get("status") == "send_frame":
            s.send(json.dumps({"prompt": "x"}).encode(), 0x1)
            s.send(jpeg, 0x2)
            sent += 1
        if out1 and out2:
            break
    t1.join(timeout=5), t2.join(timeout=5)
    s.close()
    assert len(out1) >= 1 and len(out2) >= 1
    # server still serves HTTP after the dual-reader session
    head, body = _http_get(port, "/api/queue")
    assert b"200" in head.split(b"\r\n")[0]


def test_batched_two_users_beat_single_aggregate():
    """VERDICT round-1 item 7: with the MultiStream-backed batched server,
    2 concurrent users must sustain >1.5x the single-user aggregate.

    The synthetic batched pipeline charges its latency once per ROUND (the
    batching contract: S sessions share one model dispatch), so aggregate
    throughput must scale with users instead of serialising like the
    single-pipeline path (/root/reference/demo/app.py:97-123)."""
    latency, duration = 0.05, 2.5

    def run_case(users):
        port = _free_port()
        pipeline = BatchedDemoPipeline(
            "unused", 64, 64, sessions=2, synthetic=True,
            synthetic_latency=latency,
        )
        app = App(pipeline, max_users=2)
        _start_server(app, port)
        counts = {}
        threads = [
            threading.Thread(target=_pump_user,
                             args=(port, f"user{i}", duration, counts),
                             daemon=True)
            for i in range(users)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=duration + 5)
        return sum(counts.values())

    single = run_case(1)
    double = run_case(2)
    assert single > 10, f"single-user baseline too low: {single}"
    assert double > 1.5 * single, (
        f"2-user aggregate {double} not >1.5x single {single}"
    )


# ---------------------------------------------------------------------------
# BatchedDemoPipeline over the tiny port pipeline, on the CPU
# ---------------------------------------------------------------------------

TINY_CONFIG = {"num_inference_steps": 50, "t_index_list": [30, 40]}


def _user_frames(seed, n):
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 256, (64, 64, 3)).astype(np.int16)
    return [np.clip(base + rs.randint(-20, 21, base.shape), 0, 255).astype(np.uint8)
            for _ in range(n)]


@pytest.fixture(scope="module")
def tiny_batched():
    return BatchedDemoPipeline(TINY_CONFIG, 64, 64, sessions=2, tiny=True, device="cpu")


def test_batched_pipeline_serves_two_users_as_single_streams(tiny_batched):
    """User a warms up (8 rounds alone), then streams every other round
    while user b warms up (masked rounds: b's slot holds no session yet),
    then both stream (plain rounds), then b alone (a masked round with a
    idle). Each user's outputs equal a single stream of the pipeline's seed
    fed that user's frames, within one uint8 level (the batched products
    round differently); a's idle round changes nothing of its stream."""
    import torch

    pipe = tiny_batched
    params = {"a": {"prompt": "a cat"}, "b": {"prompt": "a dog"}}
    frames = {"a": _user_frames(1, 16), "b": _user_frames(2, 14)}
    sent = {"a": 0, "b": 0}
    outs = {"a": [], "b": []}

    def round_(users):
        batch = {u: (params[u], frames[u][sent[u]]) for u in users}
        for u in users:
            sent[u] += 1
        got = pipe.predict_batch(batch)
        assert set(got) == set(users)
        for u, out in got.items():
            if sent[u] <= 8:
                assert out is None  # warming
            else:
                assert out.shape == (64, 64, 3) and out.dtype == np.uint8
                outs[u].append(out)

    for _ in range(8):
        round_("a")
    for i in range(8):
        round_("ab" if i % 2 else "b")
    for _ in range(3):
        round_("ab")
    round_("b")
    round_("ab")
    assert (sent["a"], sent["b"]) == (16, 13)

    stream = pipe.wrapper.stream
    for u in "ab":
        embeds = pipe.wrapper.encode_prompt(params[u]["prompt"])
        state, _ = stream.prepare(torch.from_numpy(np.stack(frames[u][:8])), embeds,
                                  seed=pipe.wrapper.seed)
        for j, out in enumerate(outs[u]):
            state, ref = stream(state, torch.from_numpy(frames[u][8 + j]))
            diff = int(np.abs(ref.numpy().astype(int) - out.astype(int)).max())
            assert diff <= 1, (u, j, diff)


def test_server_flags_match_the_demo_and_default_to_the_card():
    args = server_module.build_argparser().parse_args(["--sessions", "2"])
    assert args.device == "cuda" and args.sessions == 2 and args.kv_cache is None
    assert isinstance(server_module.make_pipeline(
        server_module.build_argparser().parse_args(["--synthetic"])), DemoPipeline)
    assert isinstance(server_module.make_pipeline(server_module.build_argparser().parse_args(
        ["--synthetic", "--sessions", "3"])), BatchedDemoPipeline)


def test_mjpeg_frames_are_encoded_by_framepump_where_it_builds():
    from live2diff_tpu_torch.serve import framepump

    before = dict(server_module.jpeg_encoder_counts)
    jpg = server_module.array_to_jpeg(np.full((16, 24, 3), 90, np.uint8))
    assert jpg[:2] == b"\xff\xd8"
    route = "libjpeg" if framepump.available() else "pillow"
    assert server_module.jpeg_encoder_counts[route] == before[route] + 1


def test_release_during_a_round_waits_for_it():
    """A user who disconnects while a round that holds their slot runs (the
    event loop's release against the dispatcher thread's round) frees the
    slot after the round, which completes."""
    import threading

    import torch

    class _Multi:
        def prepare_session(self, states, slot, frames, embeds, seed=0):
            return "states", None

        def __call__(self, states, frames, active=None):
            time.sleep(0.3)
            return states, torch.from_numpy(255 - frames)

    class _Wrapper:
        seed = 1

        def encode_prompt(self, prompt):
            return None

    pipe = BatchedDemoPipeline("unused", 8, 8, sessions=2, synthetic=True)
    pipe.synthetic, pipe.multi, pipe.wrapper = False, _Multi(), _Wrapper()
    frame = np.full((8, 8, 3), 7, np.uint8)
    for _ in range(8):
        assert pipe.predict_batch({"a": ({"prompt": "x"}, frame)}) == {"a": None}
    result = {}
    round_ = threading.Thread(target=lambda: result.update(
        pipe.predict_batch({"a": ({"prompt": "x"}, frame)})))
    round_.start()
    time.sleep(0.1)  # the round is inside its step
    pipe.release("a")
    round_.join(5)
    assert result["a"].shape == (8, 8, 3) and int(result["a"][0, 0, 0]) == 248
    assert pipe._slots == {} and sorted(pipe._free) == [0, 1]
