"""The trainer on the CPU: synthetic clips and the clip dataset
against the JAX package's, the tiny trainer overfitting its clip, a save
and resume equal to the uninterrupted run, ``--sd-checkpoint`` ingest of a
synthetic LDM checkpoint (UNet, VAE and the CLIP that encodes the
caption), and the CLI."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from live2diff_tpu import train as jax_train
from live2diff_tpu.parallel import data as jax_data
from live2diff_tpu_torch import train as T
from live2diff_tpu_torch.models.text_encoder import CLIPTextModelWithFinalNorm
from live2diff_tpu_torch.parallel import data as port_data
from live2diff_tpu_torch.parallel.checkpoint import STATE_FILE, latest_step_dir
from live2diff_tpu_torch.parallel.train import is_motion_param
from live2diff_tpu_torch.utils.tokenizer import CLIPTokenizer


def _motion(trainer):
    return {n: p.detach().clone() for n, p in trainer.unet.named_parameters()
            if is_motion_param(n)}


@pytest.mark.parametrize("kw", [dict(tiny=True), dict(batch=3, clip_len=5, height=16, width=24)])
def test_synthetic_clips_equal_jax(kw):
    ours = next(T.synthetic_clips(T.TrainerConfig(**kw)))
    theirs = next(jax_train.synthetic_clips(jax_train.TrainerConfig(**kw)))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_tiny_trainer_overfits_its_clip():
    """The JAX trainer test's criterion (tests/test_train_driver.py): the
    loss's tail mean below its head mean, on the fixed synthetic clip; the
    motion modules moved, nothing else did."""
    trainer = T.Trainer(T.TrainerConfig(tiny=True, steps=30, lr=2e-3, log_every=0),
                        device="cpu")
    frozen = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()
              if not is_motion_param(n)}
    vae = [p.detach().clone() for p in trainer.vae.parameters()]
    before = _motion(trainer)
    stats = trainer.fit()
    assert stats["steps"] == 30 and np.isfinite(stats["losses"]).all()
    assert stats["loss_tail_mean"] < stats["loss_head_mean"], stats
    after = _motion(trainer)
    assert all(not torch.equal(before[n], after[n]) for n in before)
    for name, p in trainer.unet.named_parameters():
        if not is_motion_param(name):
            assert torch.equal(p, frozen[name]), name
    assert all(torch.equal(a, b) for a, b in zip(trainer.vae.parameters(), vae))


def test_save_and_resume_equal_the_uninterrupted_run(tmp_path):
    kw = dict(tiny=True, lr=1e-3, log_every=0, save_every=0)
    whole = T.Trainer(T.TrainerConfig(steps=4, **kw), device="cpu")
    losses = whole.fit()["losses"]

    first = T.Trainer(T.TrainerConfig(steps=2, ckpt_dir=str(tmp_path), **kw), device="cpu")
    head = first.fit()["losses"]
    assert latest_step_dir(str(tmp_path)) == str(tmp_path / "step_2")
    assert os.path.isfile(tmp_path / "step_2" / STATE_FILE)
    resumed = T.Trainer(T.TrainerConfig(steps=4, ckpt_dir=str(tmp_path), resume=True, **kw),
                        device="cpu")
    assert resumed.state.step == 2
    tail = resumed.fit()["losses"]
    assert head + tail == losses  # bit for bit
    a, b = _motion(whole), _motion(resumed)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert torch.equal(whole.state.generator.get_state(), resumed.state.generator.get_state())
    # at the target, a resumed run takes no step
    done = T.Trainer(T.TrainerConfig(steps=4, ckpt_dir=str(tmp_path), resume=True, **kw),
                     device="cpu")
    assert done.state.step == 4 and done.fit()["steps"] == 0


def _frame_folders(root, rs):
    from PIL import Image

    for name, n in (("b_clip", 7), ("a_clip", 10)):
        folder = root / name
        folder.mkdir(parents=True)
        for i in range(n):
            img = (rs.rand(20, 28, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(folder / f"frame_{i}.png")
    (root / "notes.txt").write_text("not a video")


def test_clip_dataset_windows_and_batches_equal_jax(tmp_path):
    _frame_folders(tmp_path, np.random.RandomState(0))
    kw = dict(clip_len=3, stride=2, height=16, width=16)
    ours = port_data.ClipDataset(str(tmp_path), **kw)
    theirs = jax_data.ClipDataset(str(tmp_path), **kw)
    assert ours.paths == theirs.paths == port_data.list_videos(str(tmp_path))
    assert ours.index == theirs.index and len(ours) == len(theirs) == 4 + 3
    assert port_data.clip_windows(10, 3, 2) == jax_data.clip_windows(10, 3, 2)
    assert port_data.clip_windows(2, 3, 1) == []
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours.clip(i), theirs.clip(i))
    a, b = ours.batches(2, seed=5), theirs.batches(2, seed=5)
    for _ in range(5):  # across an epoch boundary
        np.testing.assert_array_equal(next(a), next(b))


def test_trainer_reads_a_clip_folder(tmp_path):
    _frame_folders(tmp_path / "videos", np.random.RandomState(1))
    trainer = T.Trainer(T.TrainerConfig(tiny=True, data=str(tmp_path / "videos"), steps=2,
                                        clip_len=3, height=16, width=16, log_every=0),
                        device="cpu")
    assert trainer.fit()["steps"] == 2


def _write_ldm_checkpoint(root, clip_width=12):
    """A synthetic LDM checkpoint for the tiny trainer (a few UNet and VAE
    keys in the LDM layout, every CLIP weight at ``clip_width``) and the
    tokenizer files beside it."""
    from _torch_checkpoints import LDM_UNET, draw, module_shapes

    rs = np.random.RandomState(3)
    unet_shapes = module_shapes(lambda: T.UNet3DConditionModel(T.UNetConfig(**T.TINY_UNET)))
    sd = {k: draw(v, unet_shapes[v], rs) for k, v in LDM_UNET.items()}
    sd["first_stage_model.encoder.conv_in.weight"] = draw("w.weight", (8, 3, 3, 3), rs)
    sd["first_stage_model.quant_conv.bias"] = draw("b.bias", (8,), rs)
    config = T.clip_config({"text_model.final_layer_norm.weight": torch.zeros(clip_width)})
    clip_shapes = module_shapes(lambda: CLIPTextModelWithFinalNorm(config))
    clip = {k: draw(k, s, rs) for k, s in clip_shapes.items() if "position_ids" not in k}
    sd.update({f"cond_stage_model.transformer.{k}": v for k, v in clip.items()})
    path = root / "model.ckpt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    tok = CLIPTokenizer.tiny()
    (root / "vocab.json").write_text(json.dumps(tok.encoder))
    (root / "merges.txt").write_text("#version: 0.2\n")
    return str(path), sd, clip, config


def test_sd_checkpoint_loads_the_unet_the_vae_and_the_clip(tmp_path):
    from _torch_checkpoints import LDM_UNET

    path, sd, clip, config = _write_ldm_checkpoint(tmp_path)
    trainer = T.Trainer(T.TrainerConfig(tiny=True, sd_checkpoint=path, caption="a red fox",
                                        steps=2, log_every=0), device="cpu")
    unet = dict(trainer.unet.named_parameters())
    for ldm_key, key in LDM_UNET.items():
        np.testing.assert_array_equal(unet[key].detach().numpy(), sd[ldm_key])
    vae = dict(trainer.vae.named_parameters())
    np.testing.assert_array_equal(vae["encoder.conv_in.weight"].detach().numpy(),
                                  sd["first_stage_model.encoder.conv_in.weight"])
    np.testing.assert_array_equal(vae["quant_conv.bias"].detach().numpy(),
                                  sd["first_stage_model.quant_conv.bias"])
    # the caption through the checkpoint's CLIP, not a random one
    model = CLIPTextModelWithFinalNorm(config)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in clip.items()}, strict=False)
    ids = CLIPTokenizer.from_pretrained(str(tmp_path))(["a red fox"])
    ids = torch.from_numpy(ids.astype(np.int64))
    with torch.no_grad():
        want = model(ids)
    assert trainer.text_embeds.shape == (1, 77, 12)
    torch.testing.assert_close(trainer.text_embeds, want, rtol=1e-6, atol=1e-6)
    assert trainer.fit()["steps"] == 2  # the ingested model trains


def test_sd_checkpoint_clip_of_another_width_raises(tmp_path):
    path, *_ = _write_ldm_checkpoint(tmp_path, clip_width=16)
    with pytest.raises(ValueError, match="cross_attention_dim"):
        T.Trainer(T.TrainerConfig(tiny=True, sd_checkpoint=path), device="cpu")


def test_main_trains_on_the_cpu_with_depth(tmp_path, capsys):
    stats = T.main(["--tiny", "--device", "cpu", "--steps", "3", "--log-every", "1",
                    "--use-depth", "--ckpt-dir", str(tmp_path), "--save-every", "2"])
    assert stats["steps"] == 3 and np.isfinite(stats["losses"]).all()
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["steps"] == 3
    assert sum(line.startswith("[train] step") for line in out) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]


def test_trainer_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Trainer(T.TrainerConfig(tiny=True))
