"""The port's recorder (live2diff_tpu_torch/utils/timing.py) and what reads
it, on the CPU.

* The recorder on a fake clock: parents, call ids, owners, self time, the
  summary's numbers and counters, the stage read (fake events: filed
  under the call that replayed, or counted as missed), and the rings staying
  bounded after 10x their capacity in spans, 10,000 wrapper-shaped calls
  included.
* The ``record_function`` ranges: under a CPU ``torch.profiler`` the span
  names appear in ``prof.events()``, nested in the call; without one no
  range is opened.
* A tiny wrapper's ``img2img`` records one ``wrapper.img2img`` a frame with
  its children and no stage events; a tiny ``MultiStream``'s rounds record
  ``multi.round``.
* The benchmark's five readers (``benchmark/metrics/``) on a synthetic
  recorder: the values computed by hand, and None with nothing recorded or
  without a recorder (a program that has none).
* The KL codec (a narrow one in place of SD-1.5's): a marked step records a
  (before, after) event pair around each of its two attentions, between
  the encode's and the decode's boundaries, and its eager steps count 52
  GroupNorms (none on the kernel, fp32 on the CPU) and 2 attentions in
  ``codec_routes``; a TAESD step makes no
  such event and counts none; the recorder sums the pairs into
  ``device.codec_attn``, outside ``step_device_ms``; and the two readers of
  that stage, by hand and None where a call has no such stage.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from _torch_checkpoints import config_without_paths, write_checkpoints
from live2diff_tpu_torch.stream.multi import MultiStream
from live2diff_tpu_torch.utils import timing
from live2diff_tpu_torch.utils.timing import CODEC_ATTN, STAGES, Recorder
from live2diff_tpu_torch.wrapper import WARMUP_FRAMES, StreamV2VWrapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("entry_host_ms", "call_idle_pct", "unet_ms", "depth_ms", "codec_ms")
KL_READERS = ("codec_attn_ms", "codec_attn_roofline_pct")
NARROW_VAE = dict(block_out_channels=(8, 8, 16, 16), norm_num_groups=4)
# one frame step of the KL codec: the encode (4 levels of 2 resnets, the
# mid block's 2 resnets and attention, the output norm) and the decode (the
# mid block, 4 levels of 3 resnets, the output norm), 2 GroupNorms a resnet;
# an fp32 CPU step takes the GroupNorm kernel at none of them
KL_STEP_ROUTES = {"kl_group_norm": (8 * 2 + 5 + 1) + (5 + 12 * 2 + 1), "kl_group_norm_kernel": 0,
                  "kl_attention": 2}
OVERRIDES = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                 cross_attention_dim=768, norm_num_groups=4, motion_num_attention_heads=2)
H = W = 64


class Clock:
    """A ``perf_counter_ns`` that moves only when told."""

    def __init__(self):
        self.ns = 10 ** 9

    def __call__(self) -> int:
        return self.ns

    def wait(self, ms: float) -> None:
        self.ns += int(round(ms * 1e6))


class FakeEvent:
    """A stage event at ``at_ms`` on the device's clock."""

    def __init__(self, at_ms: float, done: bool = True):
        self.at_ms, self.done = at_ms, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, other: "FakeEvent") -> float:
        return other.at_ms - self.at_ms


def fake_elapsed_ms(events):
    """``timing.elapsed_ms`` for ``FakeEvent``s (the real one asks libcuda)."""
    if not events[-1].query():
        return None
    return [events[0].elapsed_time(e) for e in events[1:]]


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(timing, "_perf_ns", c)
    monkeypatch.setattr(timing, "elapsed_ms", fake_elapsed_ms)
    return c


def fake_events(stage_ms, done=True, attn_ms=None):
    """The boundary events of ``stage_ms``; with ``attn_ms`` (the encode's
    and the decode's attention), a pair for each, 0.25 ms into its stage."""
    at = np.concatenate([[5.0], 5.0 + np.cumsum(stage_ms)])
    events = [FakeEvent(float(t), done) for t in at]
    for stage, ms in zip((1, 4), attn_ms or ()):
        start = float(at[stage]) + 0.25
        events += [FakeEvent(start, done), FakeEvent(start + ms, done)]
    return events


def wrapper_shaped_call(rec, owner, clock, host=(1.0, 0.5, 0.25, 0.5, 0.25), sync=20.0,
                        stage_ms=None, attn_ms=None):
    """One call shaped as the wrapper's on the card: preprocess, stream.step
    (upload, replay, clone), sync, fetch, postprocess, with the given ms."""
    pre, upload, replay, fetch, post = host
    with rec.root("wrapper.img2img", owner):
        with rec.span("wrapper.preprocess"):
            clock.wait(pre)
        with rec.span("stream.step"):
            with rec.span("stream.upload"):
                clock.wait(upload)
            with rec.span("stream.replay"):
                clock.wait(replay)
            if stage_ms is not None:
                rec.stages_pending(fake_events(stage_ms, attn_ms=attn_ms))
            with rec.span("stream.clone"):
                pass
        with rec.span("wrapper.sync"):
            clock.wait(sync)
        rec.read_stages(owner)
        with rec.span("wrapper.fetch"):
            clock.wait(fetch)
        with rec.span("wrapper.postprocess"):
            clock.wait(post)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_spans_carry_their_parent_call_and_owner(clock):
    rec = Recorder()
    a, b = rec.owner(), rec.owner()
    with rec.span("outside"):  # no root open: nothing recorded
        clock.wait(1)
    for k in range(3):
        with rec.root("wrapper.img2img", a):
            clock.wait(1)
            with rec.span("stream.step"):
                with rec.span("stream.replay"):
                    clock.wait(2)
                clock.wait(3)
        with rec.root("multi.round", b):
            clock.wait(7)
    calls_a, calls_b = rec.calls(a), rec.calls(b)
    assert [c.call for c in calls_a] == [0, 1, 2] and [c.call for c in calls_b] == [0, 1, 2]
    assert rec.latest_owner() == b and rec.calls() == calls_b
    first = calls_a[0]
    assert first.ms == 6.0 and first.stages is None and first.device_ms is None
    assert first.spans == {"stream.step": 5_000_000, "stream.replay": 2_000_000}
    assert calls_b[1].spans == {} and calls_b[1].ms == 7.0
    spans = rec.summary(a)["spans"]  # self time: a span's less its children's
    assert spans["wrapper.img2img"]["self_median_ms"] == 1.0
    assert spans["stream.step"]["self_median_ms"] == 3.0
    assert spans["stream.replay"]["self_median_ms"] == 2.0
    # parents by sequence number: replay's parent is step, step's is the root
    names = {rec._name[i]: (seq, rec._parent[i]) for i, seq in rec._closed(a) if rec._call[i] == 2}
    assert names["stream.replay"][1] == names["stream.step"][0]
    assert names["stream.step"][1] == names["wrapper.img2img"][0]
    assert names["wrapper.img2img"][1] == -1
    assert rec.calls(a, skip_first=1, skip_last=1) == calls_a[1:2]


def test_summary_numbers_self_time_and_counters(clock):
    rec = Recorder()
    owner, other = rec.owner(), rec.owner()
    for ms in (50.0, 10.0, 20.0, 30.0):  # the first call is left out of the statistics
        with rec.root("wrapper.img2img", owner):
            with rec.span("wrapper.sync"):
                clock.wait(ms - 4)
            clock.wait(4)
    rec.count("filter_skips", owner)
    rec.count("filter_skips", other)
    rec.count("captures", seconds=1.5)
    rec.count("captures", seconds=0.5)
    rec.count("kernel_loads", seconds=3.0)
    s = rec.summary(owner)
    call = s["spans"]["wrapper.img2img"]
    assert call["count"] == 4 and call["median_ms"] == 20.0 and call["mean_ms"] == 20.0
    assert call["std_ms"] == pytest.approx(np.std([10.0, 20.0, 30.0]))
    assert call["p95_ms"] == pytest.approx(np.percentile([10.0, 20.0, 30.0], 95))
    assert call["self_median_ms"] == 4.0 and s["spans"]["wrapper.sync"]["self_median_ms"] == 16.0
    ema = 50.0
    for ms in (10.0, 20.0, 30.0):
        ema = 0.9 * ema + 0.1 * ms
    assert call["ema_ms"] == pytest.approx(ema) and rec.ema_s(owner, "wrapper.img2img") == \
        pytest.approx(ema / 1e3)
    assert s["stages"] == {}
    assert s["counters"] == {"calls": 4, "filter_skips": 1, "captures": 2, "captures_s": 2.0,
                             "kernel_loads": 1, "kernel_loads_s": 3.0}
    assert rec.summary(other)["counters"]["calls"] == 0


def test_stage_events_filed_under_the_call_that_replayed(clock):
    rec = Recorder()
    owner = rec.owner()
    stage_ms = [4.0, 3.0, 30.0, 0.5, 2.5]
    rec.stages_pending(fake_events(stage_ms))  # outside a call: ignored
    wrapper_shaped_call(rec, owner, clock, stage_ms=stage_ms)
    with rec.root("multi.round", owner):  # a replay not yet done when read
        rec.stages_pending(fake_events(stage_ms, done=False))
    rec.read_stages(owner)
    rec.read_stages(owner)  # nothing pending: nothing happens
    calls = rec.calls(owner)
    assert calls[0].stages == pytest.approx(dict(zip(STAGES, stage_ms)))
    assert calls[0].device_ms == pytest.approx(sum(stage_ms)) and calls[1].stages is None
    s = rec.summary(owner)
    assert s["stages"]["device.unet"]["median_ms"] == pytest.approx(30.0)
    assert s["stages"]["device.unet"]["count"] == 1
    assert s["counters"]["stage_reads_missed"] == 1


def test_codec_attention_pairs_are_one_stage_outside_the_steps_device_time(clock):
    """Boundary events alone give exactly ``STAGES`` (a TAESD step's);
    with a pair around each of the KL codec's attentions the pairs' spans,
    summed, are ``device.codec_attn``, which ``device_ms`` leaves out (the
    pairs lie inside the encode and decode stages)."""
    rec = Recorder()
    owner = rec.owner()
    stage_ms = [4.0, 3.0, 30.0, 0.5, 2.5]
    wrapper_shaped_call(rec, owner, clock, stage_ms=stage_ms)
    wrapper_shaped_call(rec, owner, clock, stage_ms=stage_ms, attn_ms=[0.75, 0.5])
    plain, kl = rec.calls(owner)
    assert list(plain.stages) == list(STAGES)
    assert list(kl.stages) == [*STAGES, CODEC_ATTN]
    assert kl.stages[CODEC_ATTN] == pytest.approx(1.25)
    assert kl.device_ms == pytest.approx(plain.device_ms) == pytest.approx(sum(stage_ms))
    s = rec.summary(owner)
    assert s["stages"][CODEC_ATTN]["count"] == 1 and s["stages"]["device.unet"]["count"] == 2
    assert s["stages"][CODEC_ATTN]["median_ms"] == pytest.approx(1.25)


def test_rings_stay_bounded_after_ten_times_their_capacity(clock):
    rec = Recorder()
    owner = rec.owner()
    lengths = [len(rec._name), len(rec._start), len(rec._stages)]
    events = fake_events([1.0] * len(STAGES))
    n = 10 * rec.capacity // 2  # two spans a call
    for _ in range(n):
        with rec.root("wrapper.img2img", owner):
            with rec.span("wrapper.sync"):
                clock.wait(1)
            rec.stages_pending(events)
        rec.read_stages(owner)
    assert [len(rec._name), len(rec._start), len(rec._stages)] == lengths
    s = rec.summary(owner)
    assert s["spans"]["wrapper.img2img"]["count"] == s["spans"]["wrapper.sync"]["count"] \
        == rec.capacity // 2
    assert s["stages"]["device.depth"]["count"] == rec.stage_capacity
    calls = rec.calls(owner)
    assert [c.call for c in calls] == list(range(n - rec.capacity // 2, n))
    assert s["counters"]["calls"] == n and calls[-1].stages is not None


def test_summary_after_ten_thousand_calls_holds_no_more_than_the_ring(clock):
    rec = Recorder()
    owner = rec.owner()
    assert rec.capacity >= 4096 * 9 and rec.stage_capacity >= 4096
    for _ in range(10_000):
        wrapper_shaped_call(rec, owner, clock, stage_ms=[1.0] * len(STAGES))
    s = rec.summary(owner)
    assert sum(v["count"] for v in s["spans"].values()) <= rec.capacity
    assert all(v["count"] <= rec.stage_capacity for v in s["stages"].values())
    assert s["spans"]["wrapper.img2img"]["count"] >= 4096
    assert len(rec.calls(owner)) >= 4096 and s["counters"]["calls"] == 10_000
    assert len(rec._name) == rec.capacity and len(rec._stages) == rec.stage_capacity


def test_spans_open_record_function_ranges_only_under_the_profiler(monkeypatch):
    rec = Recorder()
    owner = rec.owner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.call"):
            with rec.root("wrapper.img2img", owner):
                with rec.span("wrapper.preprocess"):
                    torch.ones(8).add_(1)
    events = {e.name: e for e in prof.events()}
    assert {"wrapper.img2img", "wrapper.preprocess"} <= set(events)
    assert events["wrapper.preprocess"].cpu_parent.name == "wrapper.img2img"
    assert events["wrapper.img2img"].cpu_parent.name == "bench.call"
    opened = []
    monkeypatch.setattr(timing, "record_function", lambda name: opened.append(name))
    with rec.root("wrapper.img2img", owner):
        with rec.span("wrapper.preprocess"):
            pass
    assert opened == [] and len(rec.calls(owner)) == 2


# ---------------------------------------------------------------------------
# the wrapper and MultiStream on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wrapper(tmp_path_factory):
    ckpt = write_checkpoints(tmp_path_factory.mktemp("ckpt"), OVERRIDES)
    return StreamV2VWrapper(config_without_paths(ckpt), height=H, width=W, use_depth=False,
                            use_text_encoder=False, output_type="np", dtype="float32",
                            unet_overrides=OVERRIDES, seed=3, device="cpu")


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, H, W, 3)).astype(np.uint8)


def test_img2img_records_one_call_a_frame_with_its_children(wrapper):
    frames = _frames(WARMUP_FRAMES + 3, seed=4)
    wrapper.prepare("x", frames[:WARMUP_FRAMES])
    before = wrapper.trace_summary()["counters"]["calls"]
    for f in frames[WARMUP_FRAMES:]:
        wrapper(f)
    calls = timing.RECORDER.calls(wrapper.owner, skip_first=before)
    assert [c.call for c in calls] == [before, before + 1, before + 2]
    for c in calls:
        # on the CPU: no sync, no fetch, no replay, no stage events
        assert set(c.spans) == {"wrapper.preprocess", "stream.step", "wrapper.postprocess"}
        assert c.stages is None and sum(c.spans.values()) < c.end_ns - c.start_ns
    s = wrapper.trace_summary()
    assert s["counters"]["calls"] == before + 3 and s["stages"] == {}
    assert "stage_reads_missed" not in s["counters"]
    assert s["spans"]["wrapper.img2img"]["count"] == before + 3
    assert wrapper.timing_summary()["ema_s"] == pytest.approx(
        s["spans"]["wrapper.img2img"]["ema_ms"] / 1e3)


def test_trace_summary_counts_the_norm_routes(wrapper):
    """``trace_summary()`` reports the process's norm calls by route: a CPU
    frame adds its GroupNorm and LayerNorm calls to the plain routes and
    none to the kernels'."""
    frames = _frames(WARMUP_FRAMES + 1, seed=8)
    wrapper.prepare("x", frames[:WARMUP_FRAMES])
    before = wrapper.trace_summary()["counters"]["norm_routes"]
    wrapper(frames[-1])
    after = wrapper.trace_summary()["counters"]["norm_routes"]
    grew = {k: after[k] - before[k] for k in after}
    assert grew["gn_kernel"] == grew["ln_kernel"] == 0
    assert grew["gn_plain"] > 0 and grew["ln_plain"] > 0


def test_multistream_rounds_record_their_calls(wrapper):
    multi = MultiStream(wrapper.stream, 2, prompt_len=77)
    warm = torch.from_numpy(np.stack([_frames(WARMUP_FRAMES, seed=s) for s in (5, 6)]))
    states, _ = multi.prepare(warm, torch.randn(2, 77, 768), seeds=[1, 2])
    for k in range(3):
        states, out = multi(states, _frames(2, seed=7 + k))
        assert out.shape == (2, H, W, 3)
    calls = timing.RECORDER.calls(multi.owner)
    assert [c.call for c in calls] == [0, 1, 2] and timing.RECORDER.latest_owner() == multi.owner
    assert all(c.spans == {} and c.stages is None for c in calls)  # the CPU rounds run eagerly
    s = multi.trace_summary()
    assert s["counters"]["calls"] == 3 and set(s["spans"]) == {"multi.round"}


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------


def reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tracing_reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


CTX = types.SimpleNamespace(traffic={"setup_calls": 2, "trace_calls": 3, "sessions": 1})


def test_readers_on_a_synthetic_recorder(monkeypatch, clock):
    rec = Recorder()
    stranger = rec.owner()
    owner = rec.owner()
    wrapper_shaped_call(rec, stranger, clock, sync=99.0, stage_ms=[9.0] * 5)
    # 2 set-up calls, 5 window calls, 1 + 3 traced calls; set-up and traced
    # calls are slow and must not count
    syncs = [100.0, 100.0, 30.0, 34.0, 31.0, 33.0, 32.0, 100.0, 100.0, 100.0, 100.0]
    unet = [50.0, 50.0, 20.0, 24.0, 21.0, 23.0, 22.0, 50.0, 50.0, 50.0, 50.0]
    for k, (sync, u) in enumerate(zip(syncs, unet)):
        host = (1.0, 0.5, 0.25, 0.5, 0.25) if 2 <= k < 7 else (9.0,) * 5
        wrapper_shaped_call(rec, owner, clock, host=host, sync=sync,
                            stage_ms=[4.0, 1.0, u, 0.5, 2.0])
        clock.wait(1.5)  # the harness between calls
    monkeypatch.setattr(timing, "RECORDER", rec)
    got = {name: reader(name)(CTX) for name in READERS}
    # window calls 2..6: host 2.5 ms each; device 4 + 1 + unet + 0.5 + 2, median unet 22;
    # periods: host 2.5 + sync + 1.5 between starts, median over calls 2..6's pairs
    periods = [2.5 + s + 1.5 for s in syncs[2:6]]
    assert got["entry_host_ms"] == pytest.approx(2.5)
    assert got["unet_ms"] == pytest.approx(22.0) and got["depth_ms"] == pytest.approx(4.0)
    assert got["codec_ms"] == pytest.approx(3.0)
    assert got["call_idle_pct"] == pytest.approx(
        100.0 * (1.0 - 29.5 / float(np.median(periods))))


def test_readers_return_none_with_nothing_recorded(monkeypatch, clock):
    monkeypatch.setattr(timing, "RECORDER", Recorder())
    assert {name: reader(name)(CTX) for name in READERS} == dict.fromkeys(READERS)
    # spans but no stage events (the CPU): the stage readers find nothing
    rec = Recorder()
    owner = rec.owner()
    for _ in range(8):
        wrapper_shaped_call(rec, owner, clock)
    monkeypatch.setattr(timing, "RECORDER", rec)
    got = {name: reader(name)(CTX) for name in READERS}
    assert got["entry_host_ms"] == pytest.approx(2.5)
    assert [got[n] for n in READERS[1:]] == [None] * 4
    # a program without a recorder
    monkeypatch.delattr(timing, "RECORDER")
    assert {name: reader(name)(CTX) for name in READERS} == dict.fromkeys(READERS)


def kl_context(cfg_name="sd15-live2diff-demo-kl", peaks=None):
    """A reader's context over the shipped configuration ``cfg_name`` and
    the 512x512 one-stream traffic, with the benchmark's work counts."""
    bench = os.path.join(REPO, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import work

    with open(os.path.join(bench, "configs", f"{cfg_name}.json")) as f:
        cfg = json.load(f)
    traffic = dict(CTX.traffic, height=512, width=512)
    return types.SimpleNamespace(traffic=traffic, cfg=cfg, peaks=peaks, work=work)


PEAKS = {"bf16_flops": 1e15, "hbm_bytes": 1e12}


def test_kl_readers_on_a_synthetic_recorder(monkeypatch, clock):
    rec = Recorder()
    owner = rec.owner()
    # 2 set-up calls, 5 window calls, 1 + 3 traced calls
    attn = [9.0, 9.0, 0.5, 0.75, 0.25, 1.0, 0.4, 9.0, 9.0, 9.0, 9.0]
    for a in attn:
        wrapper_shaped_call(rec, owner, clock, stage_ms=[4.0, 12.0, 20.0, 0.5, 20.0],
                            attn_ms=[a, a])
    monkeypatch.setattr(timing, "RECORDER", rec)
    ctx = kl_context(peaks=PEAKS)
    assert reader("codec_attn_ms")(ctx) == pytest.approx(1.0)  # median of 2 x 0.25..1.0
    least = ctx.work.least_seconds(
        ctx.work.own_calls(ctx.cfg, ctx.traffic, "codec_attention_calls"), 1e15, 1e12)
    assert least > 0
    assert reader("codec_attn_roofline_pct")(ctx) == pytest.approx(100.0 * least / 1e-3)
    assert reader("codec_attn_roofline_pct")(kl_context()) is None  # no peaks off the card
    # a TAESD configuration has no codec attention calls
    assert reader("codec_attn_roofline_pct")(kl_context("sd15-live2diff-demo", PEAKS)) is None


def test_kl_readers_return_none_without_the_stage(monkeypatch, clock):
    ctx = kl_context(peaks=PEAKS)
    monkeypatch.setattr(timing, "RECORDER", Recorder())
    assert {name: reader(name)(ctx) for name in KL_READERS} == dict.fromkeys(KL_READERS)
    # the stage events of a TAESD step, or of a program without the pairs
    rec = Recorder()
    owner = rec.owner()
    for _ in range(8):
        wrapper_shaped_call(rec, owner, clock, stage_ms=[1.0] * len(STAGES))
    monkeypatch.setattr(timing, "RECORDER", rec)
    assert reader("codec_ms")(ctx) == pytest.approx(2.0)
    assert {name: reader(name)(ctx) for name in KL_READERS} == dict.fromkeys(KL_READERS)
    monkeypatch.delattr(timing, "RECORDER")
    assert {name: reader(name)(ctx) for name in KL_READERS} == dict.fromkeys(KL_READERS)


def test_a_marked_step_records_each_stage_boundary_once_in_order(wrapper, monkeypatch):
    import live2diff_tpu_torch.stream.pipeline as pipeline

    recorded = []

    class Mark:
        def __init__(self, k):
            self.k = k

        def record(self):
            recorded.append(self.k)

    monkeypatch.setattr(pipeline, "stage_events",
                        lambda device: [Mark(k) for k in range(len(STAGES) + 1)])
    frames = _frames(WARMUP_FRAMES + 1, seed=9)
    wrapper.prepare("x", frames[:WARMUP_FRAMES])
    stream = wrapper.stream
    state = stream.init_state(seed=0)
    stream._frame_step(state, torch.from_numpy(frames[-1]), stream._prompt_embeds)
    assert recorded == []  # an eager step outside a capture records none
    with stream.stage_marks() as events:
        stream._frame_step(state, torch.from_numpy(frames[-1]), stream._prompt_embeds)
    assert recorded == list(range(len(STAGES) + 1)) and len(events) == len(STAGES) + 1
    assert stream._stage_events is None


# ---------------------------------------------------------------------------
# the KL codec's events and counters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kl_wrapper():
    """A CPU wrapper with the KL codec, narrowed (``builder.py``'s
    ``VAEConfig()`` is SD-1.5's 83 M parameters)."""
    import live2diff_tpu_torch.builder as builder
    from live2diff_tpu_torch.models.vae import VAEConfig

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(builder, "VAEConfig", lambda: VAEConfig(**NARROW_VAE))
        return StreamV2VWrapper({"num_inference_steps": 50, "t_index_list": [30, 40]},
                                height=H, width=W, use_depth=False, use_tiny_vae=False,
                                use_text_encoder=False, output_type="np", dtype="float32",
                                unet_overrides=OVERRIDES, seed=3, device="cpu")


class Marks:
    """``stage_events`` of numbered marks: ``made`` the counts asked for,
    ``recorded`` the numbers in the order recorded."""

    def __init__(self):
        self.made, self.recorded = [], []

    def __call__(self, device, count=len(STAGES) + 1):
        first = sum(self.made)
        self.made.append(count)
        return [types.SimpleNamespace(record=lambda k=k: self.recorded.append(k))
                for k in range(first, first + count)]


def test_a_marked_kl_step_brackets_each_codec_attention(kl_wrapper, monkeypatch):
    """Boundaries 0-5 as a TAESD step records them, then the encode's
    attention pair (6, 7) between boundaries 1 and 2 and the decode's (8, 9)
    between 4 and 5; the hooks go with the block."""
    import live2diff_tpu_torch.stream.pipeline as pipeline

    marks = Marks()
    monkeypatch.setattr(pipeline, "stage_events", marks)
    frames = _frames(WARMUP_FRAMES + 1, seed=12)
    kl_wrapper.prepare("x", frames[:WARMUP_FRAMES])
    stream = kl_wrapper.stream
    state = stream.init_state(seed=0)
    frame = torch.from_numpy(frames[-1])
    stream._frame_step(state, frame, stream._prompt_embeds)
    assert marks.recorded == [] and marks.made == []
    with stream.stage_marks() as events:
        stream._frame_step(state, frame, stream._prompt_embeds)
    assert marks.made == [len(STAGES) + 1, 4] and len(events) == len(STAGES) + 5
    assert marks.recorded == [0, 1, 6, 7, 2, 3, 4, 8, 9, 5]
    stream._frame_step(state, frame, stream._prompt_embeds)
    assert len(marks.recorded) == 10 and stream._stage_events is None


def test_a_marked_taesd_step_makes_no_codec_event(wrapper, monkeypatch):
    import live2diff_tpu_torch.stream.pipeline as pipeline

    marks = Marks()
    monkeypatch.setattr(pipeline, "stage_events", marks)
    frames = _frames(WARMUP_FRAMES + 1, seed=13)
    wrapper.prepare("x", frames[:WARMUP_FRAMES])
    stream = wrapper.stream
    before = wrapper.trace_summary()["counters"]["codec_routes"]
    with stream.stage_marks() as events:
        stream._frame_step(stream.init_state(seed=0), torch.from_numpy(frames[-1]),
                           stream._prompt_embeds)
    assert marks.made == [len(STAGES) + 1] and len(events) == len(STAGES) + 1
    assert marks.recorded == list(range(len(STAGES) + 1))
    assert wrapper.trace_summary()["counters"]["codec_routes"] == before


def test_codec_routes_count_each_eager_kl_step(kl_wrapper):
    """``trace_summary()`` reports the KL codec's GroupNorms, those on the
    GroupNorm kernel, and its plain attentions: 52, 0 and 2 a frame step on
    the CPU in fp32 (every step is eager here), and twice as many for
    ``prepare``: the warmup, whose 8 frames go through one encode and one
    decode, and the eager warm step."""
    frames = _frames(WARMUP_FRAMES + 2, seed=14)

    def routes():
        return kl_wrapper.trace_summary()["counters"]["codec_routes"]

    before = routes()
    kl_wrapper.prepare("x", frames[:WARMUP_FRAMES])
    after_prepare = routes()
    for f in frames[WARMUP_FRAMES:]:
        kl_wrapper(f)
    after = routes()
    twice = {k: 2 * v for k, v in KL_STEP_ROUTES.items()}
    assert {k: after_prepare[k] - before[k] for k in before} == twice
    assert {k: after[k] - after_prepare[k] for k in before} == twice
    assert "norm_routes" in kl_wrapper.trace_summary()["counters"]
