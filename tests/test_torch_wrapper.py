"""The port's StreamV2VWrapper and its host utilities, on the CPU.

* The prompt template rule and ``update_prompt`` (as tests/test_wrapper.py
  holds the JAX wrapper): a mid-stream prompt goes through the style
  template exactly as ``prepare``'s does.
* ``SimilarImageFilter``, ``preprocess_image`` and ``postprocess_image``
  against the JAX utilities on the same arrays.
* ``prepare`` and ``img2img`` against the port's builder and stream called
  directly with the same seed: equal outputs.
* ``timing_summary``'s keys.

The wrapper's pipeline is tiny (the UNet of tests/test_builder.py at
cross-attention width 768, so the full-width CLIP encoder's output fits),
fp32, without depth, built from synthetic checkpoints.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_checkpoints import config_without_paths, write_checkpoints
from live2diff_tpu.utils.filter import SimilarImageFilter as JaxFilter
from live2diff_tpu.utils.image import frames_to_uint8 as jax_frames_to_uint8
from live2diff_tpu.utils.image import postprocess_image as jax_postprocess
from live2diff_tpu.utils.image import preprocess_image as jax_preprocess
from live2diff_tpu_torch.builder import build_pipeline, encode_prompt_for_pipeline
from live2diff_tpu_torch.utils.filter import SimilarImageFilter
from live2diff_tpu_torch.utils.image import frames_to_uint8, postprocess_image, preprocess_image
from live2diff_tpu_torch.wrapper import WARMUP_FRAMES, StreamV2VWrapper

WRAPPER_OVERRIDES = dict(
    block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
    cross_attention_dim=768, norm_num_groups=4, motion_num_attention_heads=2,
)
H = W = 64
TEMPLATE = "masterpiece, {}, best quality"


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    ckpt = write_checkpoints(tmp_path_factory.mktemp("ckpt"), WRAPPER_OVERRIDES)
    return dict(config_without_paths(ckpt), prompt_template=TEMPLATE)


def _wrapper(cfg, **kw):
    args = dict(height=H, width=W, use_depth=False, output_type="np", dtype="float32",
                unet_overrides=WRAPPER_OVERRIDES, seed=3, device="cpu")
    args.update(kw)
    return StreamV2VWrapper(dict(cfg), **args)


@pytest.fixture(scope="module")
def wrapper(cfg):
    return _wrapper(cfg)


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, H, W, 3)).astype(np.uint8)


def test_update_prompt_uses_style_template(wrapper):
    via_template = wrapper.encode_prompt("a cat")
    assert via_template.shape == (1, 77, 768) and via_template.dtype == torch.float32
    wrapper.update_prompt("a cat")
    after_update = wrapper.stream._prompt_embeds
    assert torch.equal(after_update[0], via_template[0])
    assert torch.equal(via_template,
                       encode_prompt_for_pipeline(wrapper.built, TEMPLATE.replace("{}", "a cat")))
    raw = encode_prompt_for_pipeline(wrapper.built, "a cat")
    assert not torch.equal(after_update[0], raw[0])


def test_template_without_a_slot_prefixes_the_prompt(wrapper):
    wrapper.built.prompt_template = "oil painting"
    try:
        assert torch.equal(wrapper.encode_prompt("a cat"),
                           encode_prompt_for_pipeline(wrapper.built, "oil painting a cat"))
    finally:
        wrapper.built.prompt_template = TEMPLATE


def test_wrapper_builds_the_text_encoder_and_reports_the_tokenizer(cfg, wrapper):
    assert wrapper.built.text_encoder is not None
    assert wrapper.built.clip_skip == 1
    assert f"{cfg['pretrained_model_path']}/tokenizer" in wrapper.built.missing_artifacts
    assert not any(m.startswith(("param:", "shape-mismatch:"))
                   for m in wrapper.built.missing_artifacts if "text_model" not in m)


def test_prepare_and_img2img_equal_the_builder_and_stream(cfg):
    """The wrapper against build_pipeline + stream.prepare + stream(...)
    driven by hand with the same seed, config and preprocessing."""
    w = _wrapper(cfg)
    frames = _frames(WARMUP_FRAMES + 4)
    warm_out = w.prepare("a dog", frames[:WARMUP_FRAMES])
    assert warm_out.shape == (WARMUP_FRAMES, H, W, 3) and warm_out.dtype == np.uint8
    assert w.first_step_warm_s > 0.0 and w.capture_s == 0.0  # nothing to capture on the CPU
    outs = [w(f) for f in frames[WARMUP_FRAMES:]]

    built = build_pipeline(dict(cfg), H, W, dtype=torch.float32, device="cpu", use_depth=False,
                           use_text_encoder=True, unet_overrides=WRAPPER_OVERRIDES,
                           output_uint8=True)
    embeds = encode_prompt_for_pipeline(built, TEMPLATE.replace("{}", "a dog"))
    pre = np.stack([preprocess_image(f, H, W) for f in frames])
    state, ref_warm = built.stream.prepare(torch.from_numpy(pre[:WARMUP_FRAMES]), embeds, seed=3)
    np.testing.assert_array_equal(warm_out, ref_warm.numpy())
    for frame, out in zip(pre[WARMUP_FRAMES:], outs):
        state, ref = built.stream(state, torch.from_numpy(frame))
        assert out.shape == (H, W, 3) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, ref.numpy())


def test_prepare_without_the_warm_step(cfg):
    w = _wrapper(cfg, output_type="pt", use_text_encoder=False)
    out = w.prepare("x", _frames(WARMUP_FRAMES), warm_step=False)
    assert w.first_step_warm_s == 0.0
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.shape == (WARMUP_FRAMES, H, W, 3) and 0.0 <= out.min() <= out.max() <= 1.0


def test_img2img_before_prepare_raises(cfg):
    with pytest.raises(RuntimeError, match="prepare"):
        _wrapper(cfg, use_text_encoder=False).img2img(_frames(1)[0])


def test_timing_summary_keys(cfg):
    w = _wrapper(cfg, use_text_encoder=False)
    assert w.timing_summary() == {"ema_s": 0.0, "mean_s": 0.0, "std_s": 0.0, "fps": 0.0}
    frames = _frames(WARMUP_FRAMES + 3, seed=1)
    w.prepare("x", frames[:WARMUP_FRAMES])
    for f in frames[WARMUP_FRAMES:]:
        w(f)
    t = w.timing_summary()
    assert set(t) == {"ema_s", "mean_s", "std_s", "fps"}
    assert len(w.inference_time_list) == 3 and t["mean_s"] > 0 and t["fps"] > 0
    assert t["fps"] == pytest.approx(1.0 / t["mean_s"])


def test_similar_image_filter_skips_repeats_and_replays_the_output(cfg):
    w = _wrapper(cfg, use_text_encoder=False, enable_similar_image_filter=True,
                 similar_image_filter_threshold=0.5, similar_image_filter_max_skip_frame=1)
    frames = _frames(WARMUP_FRAMES + 1, seed=2)
    w.prepare("x", frames[:WARMUP_FRAMES])
    first = w(frames[-1])
    again = w(frames[-1])  # identical: similarity 1, always skipped
    assert again is first and len(w.inference_time_list) == 1


# ---------------------------------------------------------------------------
# host utilities against the JAX package's
# ---------------------------------------------------------------------------


def test_similar_image_filter_decisions_equal_jax():
    rs = np.random.RandomState(7)
    base = rs.rand(16, 16, 3).astype(np.float32)
    frames = [base + 0.02 * rs.rand(16, 16, 3).astype(np.float32) * (i % 5 == 0) * 10
              for i in range(60)]
    frames[30] = np.zeros_like(base)
    for threshold, max_skip in ((0.98, 10), (0.9, 2), (1.0, 3)):
        ours, ref = SimilarImageFilter(threshold, max_skip), JaxFilter(threshold, max_skip)
        decisions = [(ours(f) is None, ref(f) is None) for f in frames]
        assert [a for a, _ in decisions] == [b for _, b in decisions]
        assert ours.skip_count == ref.skip_count


PRE_INPUTS = {
    "uint8_hwc": lambda rs: rs.randint(0, 256, (64, 64, 3)).astype(np.uint8),
    "float01_hwc": lambda rs: rs.rand(64, 64, 3).astype(np.float32),
    "uint8_chw": lambda rs: rs.randint(0, 256, (3, 64, 64)).astype(np.uint8),
    "resize": lambda rs: rs.randint(0, 256, (48, 80, 3)).astype(np.uint8),
}


@pytest.mark.parametrize("kind", sorted(PRE_INPUTS))
def test_preprocess_image_equals_jax(kind):
    arr = PRE_INPUTS[kind](np.random.RandomState(0))
    ours, ref = preprocess_image(arr, 64, 64), jax_preprocess(arr, 64, 64)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == (64, 64, 3)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(preprocess_image(torch.from_numpy(arr), 64, 64), ref)


def test_preprocess_pil_image_equals_jax():
    from PIL import Image

    img = Image.fromarray(np.random.RandomState(1).randint(0, 256, (50, 90, 3)).astype(np.uint8))
    np.testing.assert_array_equal(preprocess_image(img, 64, 48), jax_preprocess(img, 64, 48))


@pytest.mark.parametrize("output_type", ["np", "pt", "pil", "latent"])
@pytest.mark.parametrize("source", ["float", "uint8", "float_batch"])
def test_postprocess_image_equals_jax(output_type, source):
    rs = np.random.RandomState(2)
    arr = {"float": lambda: (rs.rand(8, 8, 3) * 2.4 - 1.2).astype(np.float32),
           "uint8": lambda: rs.randint(0, 256, (8, 8, 3)).astype(np.uint8),
           "float_batch": lambda: (rs.rand(2, 8, 8, 3) * 2 - 1).astype(np.float32)}[source]()
    ours = postprocess_image(torch.from_numpy(arr), output_type)
    ref = jax_postprocess(arr, output_type)
    if output_type == "pil":
        ours, ref = ([np.asarray(x) for x in (o if isinstance(o, list) else [o])]
                     for o in (ours, ref))
    elif output_type in ("pt", "latent"):
        assert isinstance(ours, torch.Tensor)
        ours = ours.numpy()
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def test_frames_to_uint8_equals_jax():
    rs = np.random.RandomState(3)
    frames = [(rs.rand(8, 8, 3) * 2.2 - 1.1).astype(np.float32) for _ in range(3)]
    ref = jax_frames_to_uint8(frames)
    np.testing.assert_array_equal(frames_to_uint8([torch.from_numpy(f) for f in frames]), ref)
    u8 = [rs.randint(0, 256, (8, 8, 3)).astype(np.uint8) for _ in range(2)]
    np.testing.assert_array_equal(frames_to_uint8(u8), jax_frames_to_uint8(u8))
