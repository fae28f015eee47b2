"""The port's checkpoint ingest and builder against the JAX builder.

Both builders read one set of complete synthetic checkpoints
(tests/_torch_checkpoints.py: a tiny diffusers UNet, a motion ``.ckpt``
with ``module.``, ``grid`` and ``pe`` entries, an LDM DreamBooth, a kohya
style LoRA at 0.5 and a peft LCM-LoRA, TAESD), so no parameter is drawn at
random on either side and the weights can be compared exactly. Then both
streams run ``prepare`` and 10 frames with the JAX noise replayed into the
port, at tests/test_torch_pipeline.py's fp32 tolerance. Also: a LoRA's
strength changed at run time equals a fresh build at that strength, in
place; and the stand-in prompt embedding does not depend on the process.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_checkpoints import TINY_OVERRIDES, config_without_paths, write_checkpoints
from _torch_parity import rel_err, to_np
from live2diff_tpu.builder import build_pipeline as jax_build_pipeline
from live2diff_tpu_torch.builder import build_pipeline
from live2diff_tpu_torch.convert.from_jax import params_from_jax
from live2diff_tpu_torch.wrapper import StreamV2VWrapper
from test_torch_pipeline import FP32_TOL, _frames, _normal, _Replay

H = W = 64
LH, LW = H // 8, W // 8
WARM, N_FRAMES, STEPS, SEED = 8, 10, 2, 5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def builds(ckpt):
    cfg = config_without_paths(ckpt)
    jb = jax_build_pipeline(dict(cfg), height=H, width=W, use_depth=False,
                            unet_overrides=TINY_OVERRIDES, dtype=jnp.float32)
    tb = build_pipeline(dict(cfg), H, W, dtype=torch.float32, device="cpu", use_depth=False,
                        unet_overrides=TINY_OVERRIDES)
    return jb, tb


def _merged_keys(built):
    return {key for entry in built.lora_runtime.values() for _, key, *_ in entry["records"]}


def test_unet_weights_equal_jax(builds):
    jb, tb = builds
    ours = tb.unet.state_dict()
    ref = params_from_jax(jb.unet_params)
    assert set(ours) == set(ref)
    merged = _merged_keys(tb)
    assert len(merged) == 6 and merged == _merged_keys(jb)
    assert [k for k, v in ours.items() if not torch.equal(v, ref[k])] == []


def test_taesd_weights_equal_jax(builds):
    jb, tb = builds
    ref = params_from_jax(jb.stream.params["vae"])
    ours = tb.vae.state_dict()
    assert set(ours) == set(ref)
    assert all(torch.equal(v, ref[k]) for k, v in ours.items())


def test_dreambooth_and_motion_module_land_on_their_keys(ckpt, builds):
    from live2diff_tpu_torch.convert.state_dict import load_state_dict_file

    _, tb = builds
    sd = tb.unet.state_dict()
    db = load_state_dict_file(ckpt["paths"]["dreambooth"])
    assert torch.equal(sd["conv_out.bias"], db["model.diffusion_model.out.2.bias"])
    motion = load_state_dict_file(ckpt["paths"]["motion"])
    key = "down_blocks.0.motion_modules.0.temporal_transformer.proj_in.weight"
    assert torch.equal(sd[key], motion[f"module.{key}"])
    assert set(tb.vae_sd) == {"encoder.conv_in.weight"}


def test_missing_artifacts_name_the_same_files(ckpt, builds):
    jb, tb = builds
    base = ckpt["pretrained_model_path"]
    assert tb.missing_artifacts == jb.missing_artifacts == (f"{base}/vae",
                                                           f"{base}/text_encoder")


def test_missing_parameters_and_shapes_are_reported(ckpt, tmp_path):
    from safetensors.numpy import save_file

    cfg = config_without_paths(ckpt)
    bad = {"encoder.0.weight": np.zeros((64, 3, 3, 3), np.float32),  # right
           "encoder.0.bias": np.zeros(5, np.float32)}  # wrong shape
    save_file(bad, str(tmp_path / "taesd.safetensors"))
    cfg["taesd_path"] = str(tmp_path / "taesd.safetensors")
    tb = build_pipeline(cfg, H, W, dtype=torch.float32, device="cpu", use_depth=False,
                        unet_overrides=TINY_OVERRIDES, use_lcm_lora=False)
    missing = tb.missing_artifacts
    assert "shape-mismatch:encoder.0.bias (5,) vs (64,)" in missing
    assert "param:encoder.1.conv.0.weight" in missing
    assert not any(m == "param:encoder.0.weight" for m in missing)
    assert not torch.equal(tb.vae.encoder[0].bias, torch.zeros(64))  # drawn


def test_stream_matches_jax(builds):
    """prepare + 10 frames, fp32 caches, the JAX draws replayed."""
    jb, tb = builds
    jpipe, tpipe = jb.stream, tb.stream
    frames = _frames()[:WARM + N_FRAMES]
    prompt = np.random.RandomState(23).randn(1, 7, 12).astype(np.float32)
    jstate, jwarm = jpipe.prepare(frames[:WARM], jnp.asarray(prompt), seed=SEED)
    rng, r_enc = jax.random.split(jax.random.PRNGKey(SEED))
    draws = [_normal(r_enc, (WARM, LH, LW, 4))]
    for _ in range(STEPS - 1):
        rng, r = jax.random.split(rng)
        draws.append(_normal(r, (WARM, LH, LW, 4)))
    tstate, twarm = tpipe.prepare(torch.from_numpy(frames[:WARM]), torch.from_numpy(prompt),
                                  noise=_Replay(draws))
    pairs = [(to_np(twarm), np.asarray(jwarm))]
    for frame in frames[WARM:]:
        _, r_enc, r_buf = jax.random.split(jstate.rng, 3)
        replay = _Replay([_normal(r_enc, (1, LH, LW, 4)),
                          _normal(r_buf, (STEPS - 1, LH, LW, 4))])
        jstate, jout = jpipe(jstate, frame)
        tstate, tout = tpipe(tstate, torch.from_numpy(frame), noise=replay)
        pairs.append((to_np(tout), np.asarray(jout)))
    for i, (ours, ref) in enumerate(pairs):
        assert np.isfinite(ours).all() and ours.shape == ref.shape
        assert rel_err(ours, ref) < FP32_TOL, f"frame {i - 1}: {rel_err(ours, ref):.2e}"


def test_update_lora_scale_equals_fresh_builds_in_place(ckpt):
    """0.5 -> 1.25 -> 0, each against a fresh build at that strength (fp32:
    the delta and the merge add the same fp32 terms, so 1e-6 holds them)."""
    cfg = config_without_paths(ckpt)
    style = ckpt["paths"]["style_lora"]
    kw = dict(height=H, width=W, use_depth=False, use_text_encoder=False, dtype="float32",
              unet_overrides=TINY_OVERRIDES, device="cpu", output_type="np")
    w = StreamV2VWrapper(dict(cfg), **kw)
    params = dict(w.built.unet.named_parameters())
    ptrs = {k: p.data_ptr() for k, p in params.items()}

    def fresh(alpha):
        c = dict(cfg, third_party_dict=dict(cfg["third_party_dict"],
                                            lora_list=[{"lora": style, "lora_alpha": alpha}]))
        return build_pipeline(c, H, W, dtype=torch.float32, device="cpu", use_depth=False,
                              unet_overrides=TINY_OVERRIDES).unet.state_dict()

    for alpha in (1.25, 0.0):
        assert w.update_lora_scale("style-lora.safetensors", alpha) == 3
        ref = fresh(alpha)
        for k, p in params.items():
            torch.testing.assert_close(p.data, ref[k], rtol=1e-6, atol=1e-6)
        assert {k: p.data_ptr() for k, p in params.items()} == ptrs
    assert w.update_lora_scale("style-lora", 0.0) == 0
    with pytest.raises(KeyError):
        w.update_lora_scale("no-such-lora", 1.0)
    with pytest.raises(KeyError):  # ambiguous: both LoRAs' paths hold "lora"
        w.update_lora_scale("lora", 1.0)


def test_stand_in_embedding_is_the_same_in_every_process():
    code = ("from live2diff_tpu_torch.builder import stand_in_prompt_embedding as f; "
            "import hashlib; print(hashlib.sha256(f('a cat in the rain').tobytes()).hexdigest())")
    outs = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed)
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout.strip())
    assert outs[0] == outs[1]
    from live2diff_tpu_torch.builder import stand_in_prompt_embedding

    emb = stand_in_prompt_embedding("a cat in the rain")
    assert emb.shape == (1, 77, 768) and emb.dtype == np.float32
    assert not np.array_equal(emb, stand_in_prompt_embedding("a dog"))
