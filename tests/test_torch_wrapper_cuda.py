"""StreamV2VWrapper on the card, at a narrow width.

A 256x256 stream through a narrow UNet (cross-attention width 768, so the
full-width CLIP encoder's output fits), built from synthetic checkpoints
(tests/_torch_checkpoints.py, written as torch pickles; chip_smoke.py's
phase 12 reads ``.safetensors`` files on the card), int8 KV cache, bf16. These need an NVIDIA Hopper GPU and
``nvcc``; without a CUDA device each test skips. Run them on the card,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_wrapper_cuda.py

* ``prepare`` captures the step, so the first ``img2img`` captures nothing
  and launches nothing through the wrappers; its replays equal the eager
  step on a twin state bit for bit.
* ``update_lora_scale`` writes into the parameters the graph holds: their
  addresses do not move, and the replays after it equal the eager step
  with the new weights bit for bit, and differ from the old weights'.
* The text encoder's causal bias takes the dense path on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_checkpoints import config_without_paths, write_checkpoints
from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.utils.image import preprocess_image
from live2diff_tpu_torch.wrapper import WARMUP_FRAMES, StreamV2VWrapper

pytestmark = pytest.mark.cuda

SIZE = 256
NARROW = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2,
              cross_attention_dim=768, norm_num_groups=8, motion_num_attention_heads=2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cfg(dev, tmp_path_factory):
    return config_without_paths(write_checkpoints(tmp_path_factory.mktemp("ckpt"), NARROW,
                                                  safetensors=False))


def _wrapper(cfg, dev):
    return StreamV2VWrapper(dict(cfg), height=SIZE, width=SIZE, use_depth=False,
                            output_type="np", kv_cache_dtype="int8", unet_overrides=NARROW,
                            device=dev, seed=3)


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


def _twin(w, frames, prompt):
    """A second state of the wrapper's stream, prepared as the wrapper's was."""
    pre = np.stack([preprocess_image(f, SIZE, SIZE) for f in frames[:WARMUP_FRAMES]])
    state, _ = w.stream.prepare(torch.from_numpy(pre), w.encode_prompt(prompt), seed=w.seed)
    return state


def _eager(w, state, frame):
    pre = torch.from_numpy(preprocess_image(frame, SIZE, SIZE)).to(w.device)
    state, out = w.stream._frame_step(state, pre, w.stream._prompt_embeds)
    return state, out.cpu().numpy()


def test_first_img2img_after_prepare_captures_nothing(dev, cfg):
    w = _wrapper(cfg, dev)
    frames = _frames(WARMUP_FRAMES + 4)
    warm = w.prepare("a cat", frames[:WARMUP_FRAMES])
    assert warm.shape == (WARMUP_FRAMES, SIZE, SIZE, 3) and warm.dtype == np.uint8
    assert w.capture_s > 0.0 and w.first_step_warm_s > 0.0
    twin = _twin(w, frames, "a cat")
    n_graphs, counts = len(w.stream._graphs.graphs), dict(_build.launch_counts)
    for frame in frames[WARMUP_FRAMES:]:
        out = w(frame)
        twin, ref = _eager(w, twin, frame)
        assert out.shape == (SIZE, SIZE, 3) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, ref)
    assert len(w.stream._graphs.graphs) == n_graphs
    # the eager twin's steps launch kernels; the replays none
    eager_counts = dict(_build.launch_counts)
    w(frames[-1])
    assert dict(_build.launch_counts) == eager_counts
    assert counts != eager_counts


def test_update_lora_scale_is_seen_by_replays(dev, cfg):
    w = _wrapper(cfg, dev)
    frames = _frames(WARMUP_FRAMES + 4, seed=1)
    w.prepare("a cat", frames[:WARMUP_FRAMES])
    twin, old = _twin(w, frames, "a cat"), _twin(w, frames, "a cat")
    old_outs = []
    for frame in frames[WARMUP_FRAMES:]:  # the old weights, all four frames
        old, out = _eager(w, old, frame)
        old_outs.append(out)
    for frame in frames[WARMUP_FRAMES:WARMUP_FRAMES + 2]:
        twin, ref = _eager(w, twin, frame)
        np.testing.assert_array_equal(w(frame), ref)
    params = dict(w.built.unet.named_parameters())
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    before = params["conv_in.weight"].clone()
    n_graphs = len(w.stream._graphs.graphs)
    assert w.update_lora_scale("style-lora", 1.25) == 3
    assert {k: p.data_ptr() for k, p in params.items()} == ptrs
    assert not torch.equal(params["conv_in.weight"], before)
    differs = []
    for i, frame in enumerate(frames[WARMUP_FRAMES + 2:], start=2):
        twin, ref = _eager(w, twin, frame)
        out = w(frame)
        np.testing.assert_array_equal(out, ref)
        differs.append(not np.array_equal(out, old_outs[i]))
    assert len(w.stream._graphs.graphs) == n_graphs
    assert any(differs)


def test_text_encoder_bias_path_on_the_card_equals_the_cpu(dev):
    from live2diff_tpu_torch.models.text_encoder import (
        CLIPTextConfig, CLIPTextModelWithFinalNorm,
    )
    from live2diff_tpu_torch.utils.tokenizer import CLIPTokenizer

    torch.manual_seed(0)
    cpu = CLIPTextModelWithFinalNorm(CLIPTextConfig(vocab_size=600, hidden_size=64,
                                                    num_layers=2, num_heads=2)).eval()
    card = CLIPTextModelWithFinalNorm(cpu.config).to(dev).eval()
    card.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(CLIPTokenizer.tiny(77)(["a cat in the rain"]).astype(np.int64))
    before = _build.launch_counts["flash_attention"]
    with torch.no_grad():
        ours = card(ids.to(dev), clip_skip=1).cpu()
        ref = cpu(ids, clip_skip=1)
    assert _build.launch_counts["flash_attention"] == before
    torch.testing.assert_close(ours, ref, rtol=1e-3, atol=1e-3)
